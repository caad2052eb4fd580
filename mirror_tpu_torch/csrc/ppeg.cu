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
// Design: both kernels share one body (conv_pairs below). A block takes
// 64 channels of a band of 8 grid rows of one image and walks the band in
// chunks of 16 columns; each chunk, with its 3-pixel halo (14 x 22 x 64
// bf16, zero SAME padding), is staged in shared memory by 16-byte cp.async,
// so each input crosses L2 about (14 x 22) / (8 x 16) = 2.4 times. Warp y
// owns band row y, a lane a channel pair (4-byte shared loads, fp32 math):
// for each tap row dy, one load of the staged row feeds the up to 7 outputs
// whose window holds it, each output summing its taps in (dy, dx) order.
// The forward (K5) starts each sum at img + b and reads the taps as they
// are; the backward's dimg starts at g and reads them flipped; each output
// is rounded once, as on the TPU. The forward stages only img (39 KB and
// the taps), so three blocks share an SM; the TPU's channel blocking
// (_cblk) and 64 MB VMEM limit have no counterpart.
// The backward's design is at ppeg_bwd_kernel.
// Element types: img, the taps, the bias, g, out and dimg are of one type
// T, bf16 (the sentences above), float16 or float32 (the Pallas kernel's
// `img.dtype`); the math is fp32 FMAs in every type and each output is
// rounded to T once. A float32 lane loads its channel pair with one 8-byte
// load, and the staged chunk doubles: the forward's 91 KB leave room for
// two blocks an SM, the backward's 170 KB for one.
#include "common.cuh"

namespace {

constexpr int KS = 7, HALO = KS / 2;
constexpr int BH = 8;    // grid rows a band: warp y takes the output row y
constexpr int BW = 16;   // grid columns a chunk: a thread's outputs
constexpr int BC = 64;   // channels a block: a pair a lane
constexpr int SBH = BH + KS - 1, SBW = BW + KS - 1;
constexpr int NT = KS * KS + 1;  // 49 taps and the bias

// Forward (K5): 8 warps, one a band row, on the shared body. Three blocks
// an SM (46 KB of shared memory each), registers held to 85 a thread.
constexpr int kFwdThreads = 32 * BH;

// Backward (K5b): one pass over g and img, as the TPU kernel makes it. A
// block of 15 warps takes (64 channels, a band of BH grid rows, one image)
// and walks the band in chunks of BW columns. Each chunk's g and img, with
// their 3-pixel halos (14 x 22 x 64 bf16 each, zero SAME padding), are
// staged in shared memory once, and both gradients are taken from them:
// - warp y < 8: dimg of band row y over the chunk's 16 columns, on the
//   shared body (conv_pairs) with the taps flipped, starting from g;
// - warp 8 + dy: dk's tap row dy over the band, a channel pair a lane: a
//   7-wide window of the img row slides along x in registers, so one load
//   feeds the 7 dx taps; the 7 x 2 sums (and, in warp 8, db's 2) stay in
//   registers across the band's chunks and rows.
// The block writes its [50, 64] partial once; launch_column_sum
// (common.cuh) sums the partials over images and bands in its fixed order
// (deterministic, no atomics). One block an SM (83 KB of shared memory;
// ptxas: 118 registers, no spills): held to 64 registers for two blocks an
// SM, it spilled.
constexpr int kDimgWarps = BH, kDkWarps = KS;
constexpr int kBwdThreads = 32 * (kDimgWarps + kDkWarps);

template <typename T>
struct FwdSmem {
  T img[SBH * SBW * BC];
  T taps[KS * KS * BC];
};

template <typename T>
struct BwdSmem {
  T g[SBH * SBW * BC];
  T img[SBH * SBW * BC];
  T taps[KS * KS * BC];
};

// Stage rows [y0 - 3, y0 + BH + 3) x columns [x0 - 3, x0 + BW + 3) x
// channels [c0, c0 + BC) of one image of src into dst, zeros outside:
// cp.async 16 bytes at a time when C is a multiple of 8, else one element
// at a time, by the block's THREADS threads.
template <int THREADS, typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* __restrict__ src, int y0, int x0,
                                            int c0, int H, int W, int C) {
  if (C % 8 == 0) {
    constexpr int V = vec16<T>(), chunks = BC / V;
    for (int idx = threadIdx.x; idx < SBH * SBW * chunks; idx += THREADS) {
      const int p = idx / chunks, gc = c0 + (idx % chunks) * V;
      const int gy = y0 + p / SBW - HALO, gx = x0 + p % SBW - HALO;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C;
      cp_async16(dst + p * BC + gc - c0, ok ? src + ((size_t)gy * W + gx) * C + gc : src, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < SBH * SBW * BC; idx += THREADS) {
    const int p = idx / BC, gc = c0 + idx % BC;
    const int gy = y0 + p / SBW - HALO, gx = x0 + p % SBW - HALO;
    dst[idx] = gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C
                   ? src[((size_t)gy * W + gx) * C + gc]
                   : Elem<T>::from_float(0.0f);
  }
}

// Channels c and c + 1 (those below C) of v at dst, which points at channel c.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, int c, int C, float2 v) {
  if (C % 2 == 0 && c < C) {
    store2(dst, v.x, v.y);
    return;
  }
  if (c < C) dst[0] = Elem<T>::from_float(v.x);
  if (c + 1 < C) dst[1] = Elem<T>::from_float(v.y);
}

__device__ __forceinline__ void fma2(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
}

// Stage the taps of channels [c0, c0 + BC) as [49][BC], zeros past C.
template <int THREADS, typename T>
__device__ __forceinline__ void stage_taps(T* dst, const T* __restrict__ kern, int c0, int C) {
  for (int idx = threadIdx.x; idx < KS * KS * BC; idx += THREADS) {
    const int gc = c0 + idx % BC;
    dst[idx] = gc < C ? kern[(size_t)(idx / BC) * C + gc] : Elem<T>::from_float(0.0f);
  }
}

// The body both kernels share: acc[xo] += the 49 taps against the staged
// tile around output (y, xo) of the chunk (tile coordinates y + dy, xo +
// dx, halo included), for this lane's channel pair at cp. For each tap
// row, one load of the tile feeds the up to 7 outputs whose window holds
// it; each output still sums its taps in (dy, dx) order. FLIP reads
// tap[6 - dy][6 - dx] (the backward's dimg).
template <bool FLIP, typename T>
__device__ __forceinline__ void conv_pairs(float2 (&acc)[BW], const T* tile, const T* taps,
                                           int y, int cp) {
#pragma unroll 1
  for (int ty = 0; ty < KS; ++ty) {
    float2 tap[KS];
#pragma unroll
    for (int dx = 0; dx < KS; ++dx)
      tap[dx] = load2(taps + (FLIP ? KS * KS - 1 - (ty * KS + dx) : ty * KS + dx) * BC + cp);
    const T* row = tile + (y + ty) * SBW * BC + cp;
#pragma unroll
    for (int xi = 0; xi < SBW; ++xi) {
      const float2 val = load2(row + xi * BC);
#pragma unroll
      for (int dx = 0; dx < KS; ++dx)
        if (xi - dx >= 0 && xi - dx < BW) fma2(acc[xi - dx], tap[dx], val);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, sizeof(T) == 4 ? 2 : 3)
    ppeg_kernel(const T* __restrict__ img, const T* __restrict__ kern,
                const T* __restrict__ bias, T* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<T>& sm = *reinterpret_cast<FwdSmem<T>*>(smem_raw);
  const int c0 = blockIdx.x * BC, band = blockIdx.y;
  const int y0 = band * BH, y = threadIdx.x / 32, cp = 2 * (threadIdx.x % 32);
  const size_t base = (size_t)blockIdx.z * H * W * C;
  stage_taps<kFwdThreads>(sm.taps, kern, c0, C);
  const float2 b = make_float2(c0 + cp < C ? Elem<T>::to_float(bias[c0 + cp]) : 0.f,
                               c0 + cp + 1 < C ? Elem<T>::to_float(bias[c0 + cp + 1]) : 0.f);
  for (int x0 = 0; x0 < W; x0 += BW) {
    if (x0 > 0) __syncthreads();  // every warp is done with the last chunk
    stage_chunk<kFwdThreads>(sm.img, img + base, y0, x0, c0, H, W, C);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (y0 + y >= H) continue;
    float2 acc[BW];  // img + b, then the taps
#pragma unroll
    for (int xo = 0; xo < BW; ++xo) {
      const float2 v = load2(sm.img + ((y + HALO) * SBW + xo + HALO) * BC + cp);
      acc[xo] = make_float2(v.x + b.x, v.y + b.y);
    }
    conv_pairs<false>(acc, sm.img, sm.taps, y, cp);
    T* dst = out + base + ((size_t)(y0 + y) * W + x0) * C + c0 + cp;
#pragma unroll
    for (int xo = 0; xo < BW; ++xo)
      if (x0 + xo < W) store_pair(dst + (size_t)xo * C, c0 + cp, C, acc[xo]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ppeg_bwd_kernel(const T* __restrict__ img, const T* __restrict__ kern,
                    const T* __restrict__ g, T* __restrict__ dimg,
                    float* __restrict__ partial, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<T>& sm = *reinterpret_cast<BwdSmem<T>*>(smem_raw);
  const int c0 = blockIdx.x * BC, band = blockIdx.y, b = blockIdx.z;
  const int y0 = band * BH, rows = min(BH, H - y0);
  const size_t base = (size_t)b * H * W * C;
  const int warp = threadIdx.x / 32, cp = 2 * (threadIdx.x % 32);
  stage_taps<kBwdThreads>(sm.taps, kern, c0, C);

  const int dy = warp - kDimgWarps;  // the dk warps' tap row
  float2 dk[KS], db = make_float2(0.f, 0.f);
#pragma unroll
  for (int dx = 0; dx < KS; ++dx) dk[dx] = make_float2(0.f, 0.f);

  for (int x0 = 0; x0 < W; x0 += BW) {
    if (x0 > 0) __syncthreads();  // every warp is done with the last chunk
    stage_chunk<kBwdThreads>(sm.g, g + base, y0, x0, c0, H, W, C);
    stage_chunk<kBwdThreads>(sm.img, img + base, y0, x0, c0, H, W, C);
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
      conv_pairs<true>(acc, sm.g, sm.taps, y, cp);
      T* out = dimg + base + ((size_t)(y0 + y) * W + x0) * C + c0 + cp;
#pragma unroll
      for (int xo = 0; xo < BW; ++xo)
        if (x0 + xo < W) store_pair(out + (size_t)xo * C, c0 + cp, C, acc[xo]);
      continue;
    }
    // dk's tap row dy: g at (y, x) against the img row y + dy - 3, x + dx - 3
    for (int y = 0; y < rows; ++y) {
      const T* grow = sm.g + ((y + HALO) * SBW + HALO) * BC + cp;
      const T* irow = sm.img + (y + dy) * SBW * BC + cp;
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
// img, kern, g and dimg of type code dtype (common.cuh's Elem); dkb: fp32
// [50, C] (the 49 taps, then the bias); partial: fp32 scratch.
MIRROR_EXPORT int mirror_ppeg_bwd(const void* img, const void* kern, const void* g,
                                  void* dimg, void* dkb, void* partial, int b, int H, int W,
                                  int C, int dtype, cudaStream_t stream) {
  const int bands = (H + BH - 1) / BH;
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    const size_t smem = sizeof(BwdSmem<T>);
    cudaError_t err = allow_smem(ppeg_bwd_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    ppeg_bwd_kernel<T><<<dim3((C + BC - 1) / BC, bands, b), kBwdThreads, smem, stream>>>(
        static_cast<const T*>(img), static_cast<const T*>(kern), static_cast<const T*>(g),
        static_cast<T*>(dimg), static_cast<float*>(partial), H, W, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_column_sum(static_cast<const float*>(partial), b * bands, (long long)NT * C,
                             static_cast<float*>(dkb), stream);
  });
}

// img, kern, bias and out of type code dtype.
MIRROR_EXPORT int mirror_ppeg(const void* img, const void* kern, const void* bias, void* out,
                              int b, int H, int W, int C, int dtype, cudaStream_t stream) {
  const dim3 grid((C + BC - 1) / BC, (H + BH - 1) / BH, b);
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    const size_t smem = sizeof(FwdSmem<T>);
    const cudaError_t err = allow_smem(ppeg_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    ppeg_kernel<T><<<grid, kFwdThreads, smem, stream>>>(
        static_cast<const T*>(img), static_cast<const T*>(kern), static_cast<const T*>(bias),
        static_cast<T*>(out), H, W, C);
    return cudaGetLastError();
  });
}
