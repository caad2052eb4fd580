// The standalone depthwise conv along the sequence (K9) and its backward
// (K9b): dv and dkern in one pass over g and v.
//
// Replaces: mirror_tpu/ops/conv1d_pallas.py::depthwise_conv1d_seq, the
// forward pallas_call of _fwd_call (_banded_kernel) and the backward one of
// _bwd_call (_bwd_kernel). For the probe scripts/exp_conv_parts.py (K11f),
// which times those two, the backward's dv alone (an instance without the
// dkern slide) and its second pass alone (mirror_column_sum) are entries too.
//
// What it computes, per (batch, head) of v [b, h, n, d] bf16 with one filter
// of K taps per head (kern [h, K], K odd, bf16: the wrapper rounds fp32 taps
// as the TPU kernel does when it builds its band in v's dtype):
// out[i] = sum_t kern[t] v[i + t - K/2], zero SAME padding, no bias, an fp32
// sum rounded once. The backward takes g in v's dtype and emits
// dv[i] = sum_t kern[t] g[i - t + K/2] (the same conv with the taps flipped,
// rounded once) and dkern[h, t] = sum over batch, rows and features of
// g[i] v[i + t - K/2] in fp32: per-block partials per (batch, row tile) and
// (head, tap), then a second pass that sums them in a fixed order
// (column_sum_kernel), so dkern is the same from run to run (no float
// atomics).
//
// What bounds it on the H100: at [16, 8, 2117, 96] with K 33 the forward
// reads and writes 2 bytes an element against 2K = 66 fp32 FLOP (104 MB,
// 31 us at 3.35 TB/s; 1.7 GFLOP, 26 us at 67 TFLOP/s): bytes, narrowly. The
// backward does twice the FLOP (dv and dkern) over 6 bytes an element:
// operations, 51 us.
//
// Design, and why not the TPU's: the TPU turns the conv into banded matmuls
// for its MXU; on Hopper the taps are plain FMAs, so the work is to keep
// them fed from shared memory. A block owns kTile = 132 rows of one (batch,
// head) and holds the haloed window of kTile + K - 1 rows (zeros outside
// [0, n), so short last tiles and n <= K/2 need no special case). A thread
// owns two adjacent features and kRun = 11 outputs and slides down the
// window with a ring of kRun rows in registers: each window row is read
// from shared memory once and meets every tap that reaches it, so one tap
// costs two FMAs and one broadcast read of the tap, instead of a read of v
// per FMA. dkern is the same slide with the roles swapped: a thread owns
// two features, kRun taps and a slice of 33 rows of g, reads each g row
// once and slides over v. Kernel 4's forward (softmax_attn.cu) carries the
// same conv fused into its attention tail; its backward (softmax_attn_bwd.cu)
// launches this file's backward through conv1d.cuh.
#include "conv1d.cuh"

namespace {

constexpr int kRun = 11;           // outputs (or taps) a thread carries in registers
constexpr int kTile = 12 * kRun;   // rows of one (batch, head) a block owns
constexpr int kSlices = 4;         // dkern: the tile's rows in slices of 33 (3 kRun)
constexpr int kThreads = 192;      // d 96: 12 runs x 48 feature pairs = 3 items a thread
constexpr int kMaxTaps = 65;
constexpr int kMaxDim = 128;

__host__ __device__ constexpr int padded_taps(int ksize) {
  return (ksize + kRun - 1) / kRun * kRun;
}

// Rows of a window: kTile + K - 1 that the taps reach, then zero rows up to
// the padded tap count so the ring's reads past the last tap stay in bounds.
__host__ __device__ constexpr int window_rows(int ksize) {
  return kTile + padded_taps(ksize) - 1;
}

struct Layout {
  int ld;  // bf16 stride of a window row
  size_t win, tap, red, total;
};

__host__ __device__ inline Layout make_layout(int d, int ksize, bool backward) {
  Layout L;
  L.ld = d + 8;
  const size_t win = smem_align((size_t)window_rows(ksize) * L.ld * sizeof(bf16));
  L.win = win;
  L.tap = (backward ? 2 : 1) * win;
  L.red = L.tap + smem_align((size_t)padded_taps(ksize) * sizeof(float));
  L.total = backward ? L.red + smem_align((size_t)kThreads * padded_taps(ksize) * sizeof(float))
                     : L.red;
  return L;
}

// Window rows [0, rows_alloc) <- source rows row0 + r of a [n, d] matrix for
// r < rows_used and row0 + r in [0, n); zeros everywhere else. 16 bytes a
// thread.
__device__ void load_window(bf16* dst, const bf16* src, int row0, int rows_used, int rows_alloc,
                            int n, int d, int ld) {
  const int chunks = d / 8;
  for (int idx = threadIdx.x; idx < rows_alloc * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_used && gr >= 0 && gr < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ float2 load_pair(const bf16* win, int ld, int row, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(win + row * ld + col));
}

// acc[x] += coef(s) * win[base + s + x] (two features at col) for s in
// [0, steps), steps a multiple of kRun. The ring holds window rows base + s
// .. base + s + kRun - 1 at slot (s + x) % kRun; unrolling s by kRun makes
// every slot index a constant, so the ring lives in registers.
template <typename Coef>
__device__ __forceinline__ void slide(float2 (&acc)[kRun], const bf16* win, int ld, int col,
                                      int base, int steps, Coef coef) {
  float2 ring[kRun];
#pragma unroll
  for (int x = 0; x < kRun - 1; ++x) ring[x] = load_pair(win, ld, base + x, col);
  for (int s0 = 0; s0 < steps; s0 += kRun) {
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      ring[(u + kRun - 1) % kRun] = load_pair(win, ld, base + s0 + u + kRun - 1, col);
      const float2 c = coef(s0 + u);
#pragma unroll
      for (int x = 0; x < kRun; ++x) {
        const float2 r = ring[(u + x) % kRun];
        acc[x].x = fmaf(c.x, r.x, acc[x].x);
        acc[x].y = fmaf(c.y, r.y, acc[x].y);
      }
    }
  }
}

// out rows [r0, r0 + kTile) of one (batch, head) from its window: the taps
// in sTap (zero-padded to padded_taps), one fp32 sum per output rounded once.
__device__ void conv_tile(const bf16* win, const float* sTap, bf16* out, int r0, int n, int d,
                          int ld, int ksize) {
  const int pairs = d / 2, items = (kTile / kRun) * pairs;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int col = 2 * (item % pairs), i0 = (item / pairs) * kRun;
    if (r0 + i0 >= n) continue;
    float2 acc[kRun];
#pragma unroll
    for (int x = 0; x < kRun; ++x) acc[x] = make_float2(0.f, 0.f);
    slide(acc, win, ld, col, i0, padded_taps(ksize), [&](int s) {
      const float w = sTap[s];
      return make_float2(w, w);
    });
#pragma unroll
    for (int x = 0; x < kRun; ++x) {
      const int row = r0 + i0 + x;
      if (row < n)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * d + col) =
            __floats2bfloat162_rn(acc[x].x, acc[x].y);
    }
  }
}

// The taps of this block's head into sTap, flipped for dv, zeros past K.
__device__ void load_taps(float* sTap, const bf16* kern, int head, int ksize, bool flip) {
  for (int t = threadIdx.x; t < padded_taps(ksize); t += kThreads)
    sTap[t] = t < ksize ? __bfloat162float(kern[head * ksize + (flip ? ksize - 1 - t : t)]) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
    conv1d_kernel(const bf16* __restrict__ v, const bf16* __restrict__ kern,
                  bf16* __restrict__ out, int heads, int n, int d, int ksize) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d, ksize, false);
  bf16* sV = reinterpret_cast<bf16*>(smem);
  float* sTap = reinterpret_cast<float*>(smem + L.tap);
  const int bh = blockIdx.y, r0 = blockIdx.x * kTile, half = ksize / 2;
  const size_t base = (size_t)bh * n * d;
  load_window(sV, v + base, r0 - half, kTile + ksize - 1, window_rows(ksize), n, d, L.ld);
  load_taps(sTap, kern, bh % heads, ksize, false);
  __syncthreads();
  conv_tile(sV, sTap, out + base, r0, n, d, L.ld, ksize);
}

// dv for the block's rows, and (kDkern) its partial of dkern per tap:
// partial[(b, tile), (h, t)] = sum over the tile's rows i and features of
// g[i] v[i + t - K/2]. The instance without kDkern is dv alone (the probe
// exp_conv_parts times it apart): the same window of g and the same slide,
// so its dv is the fused instance's bit for bit.
template <bool kDkern>
__global__ void __launch_bounds__(kThreads)
    conv1d_bwd_kernel(const bf16* __restrict__ v, const bf16* __restrict__ kern,
                      const bf16* __restrict__ g, bf16* __restrict__ dv,
                      float* __restrict__ partial, int heads, int n, int d, int ksize) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(d, ksize, kDkern);
  bf16* sG = reinterpret_cast<bf16*>(smem);
  float* sTap = reinterpret_cast<float*>(smem + L.tap);
  const int bh = blockIdx.y, r0 = blockIdx.x * kTile, half = ksize / 2;
  const size_t base = (size_t)bh * n * d;
  load_window(sG, g + base, r0 - half, kTile + ksize - 1, window_rows(ksize), n, d, L.ld);
  load_taps(sTap, kern, bh % heads, ksize, true);
  if constexpr (!kDkern) {
    __syncthreads();
    conv_tile(sG, sTap, dv + base, r0, n, d, L.ld, ksize);
    return;
  }
  bf16* sV = reinterpret_cast<bf16*>(smem + L.win);
  float* red = reinterpret_cast<float*>(smem + L.red);  // [kThreads][padded taps]
  const int kpad = padded_taps(ksize);
  load_window(sV, v + base, r0 - half, kTile + ksize - 1, window_rows(ksize), n, d, L.ld);
  for (int t = 0; t < kpad; ++t) red[threadIdx.x * kpad + t] = 0.f;
  __syncthreads();

  conv_tile(sG, sTap, dv + base, r0, n, d, L.ld, ksize);

  // dkern: an item is (feature pair, group of kRun taps, slice of rows); g
  // rows past n are zeros in the window, so they add nothing
  const int pairs = d / 2, groups = kpad / kRun, slice = kTile / kSlices;
  const int items = pairs * groups * kSlices;
  float* my = red + threadIdx.x * kpad;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int col = 2 * (item % pairs), rest = item / pairs;
    const int t0 = (rest % groups) * kRun, i_s = (rest / groups) * slice;
    float2 acc[kRun];
#pragma unroll
    for (int x = 0; x < kRun; ++x) acc[x] = make_float2(0.f, 0.f);
    // window row of g[i] is i - r0 + half; of v[i + t - K/2] is i - r0 + t
    slide(acc, sV, L.ld, col, i_s + t0, slice,
          [&](int s) { return load_pair(sG, L.ld, i_s + s + half, col); });
#pragma unroll
    for (int x = 0; x < kRun; ++x) my[t0 + x] += acc[x].x + acc[x].y;
  }
  __syncthreads();
  const int b = bh / heads, h = bh % heads;
  float* out = partial + (((size_t)b * gridDim.x + blockIdx.x) * heads + h) * ksize;
  for (int t = threadIdx.x; t < ksize; t += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < kThreads; ++j) sum += red[j * kpad + t];
    out[t] = sum;
  }
}

bool valid(int bh, int heads, int n, int d, int ksize) {
  return bh > 0 && heads > 0 && bh % heads == 0 && n > 0 && d > 0 && d % 8 == 0 &&
         d <= kMaxDim && ksize > 0 && ksize % 2 == 1 && ksize <= kMaxTaps;
}

}  // namespace

long long conv1d_bwd_partial_elems(int bh, int n, int ksize) {
  return (long long)bh * ((n + kTile - 1) / kTile) * ksize;
}

cudaError_t conv1d_bwd(const bf16* v, const bf16* kern, const bf16* g, bf16* dv, float* dkern,
                       float* partial, int bh, int heads, int n, int d, int ksize,
                       cudaStream_t stream) {
  if (!valid(bh, heads, n, d, ksize)) return cudaErrorInvalidValue;
  const size_t smem = make_layout(d, ksize, true).total;
  cudaError_t err = allow_smem(conv1d_bwd_kernel<true>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kTile - 1) / kTile;
  conv1d_bwd_kernel<true><<<dim3(tiles, bh), kThreads, smem, stream>>>(v, kern, g, dv, partial,
                                                                         heads, n, d, ksize);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dkern[h, t] = the sum over batch and row tiles of the partials
  const long long outs = (long long)heads * ksize;
  column_sum_kernel<float><<<column_sum_blocks(outs), dim3(32, 8), 0, stream>>>(
      partial, bh / heads * tiles, outs, dkern);
  return cudaGetLastError();
}

// Elements of the fp32 `partial` scratch that mirror_conv1d_bwd and the
// conv of mirror_softmax_attn_bwd need.
MIRROR_EXPORT long long mirror_conv1d_bwd_partial_elems(int bh, int n, int ksize) {
  return conv1d_bwd_partial_elems(bh, n, ksize);
}

// v, out: bf16 [bh, n, d]; kern: bf16 [heads, ksize]; d a multiple of 8 up
// to 128, ksize odd up to 65.
MIRROR_EXPORT int mirror_conv1d(const void* v, const void* kern, void* out, int bh, int heads,
                                int n, int d, int ksize, cudaStream_t stream) {
  if (!valid(bh, heads, n, d, ksize)) return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(d, ksize, false).total;
  cudaError_t err = allow_smem(conv1d_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  conv1d_kernel<<<dim3((n + kTile - 1) / kTile, bh), kThreads, smem, stream>>>(
      static_cast<const bf16*>(v), static_cast<const bf16*>(kern), static_cast<bf16*>(out),
      heads, n, d, ksize);
  return (int)cudaGetLastError();
}

// g, dv: bf16 [bh, n, d]; dkern: fp32 [heads, ksize]; partial: fp32 scratch
// of mirror_conv1d_bwd_partial_elems(bh, n, ksize) elements.
MIRROR_EXPORT int mirror_conv1d_bwd(const void* v, const void* kern, const void* g, void* dv,
                                    void* dkern, void* partial, int bh, int heads, int n, int d,
                                    int ksize, cudaStream_t stream) {
  return (int)conv1d_bwd(static_cast<const bf16*>(v), static_cast<const bf16*>(kern),
                         static_cast<const bf16*>(g), static_cast<bf16*>(dv),
                         static_cast<float*>(dkern), static_cast<float*>(partial), bh, heads, n,
                         d, ksize, stream);
}

// dv alone (the backward's first half, no dkern): g, dv bf16 [bh, n, d];
// kern bf16 [heads, ksize].
MIRROR_EXPORT int mirror_conv1d_bwd_dv(const void* kern, const void* g, void* dv, int bh,
                                       int heads, int n, int d, int ksize, cudaStream_t stream) {
  if (!valid(bh, heads, n, d, ksize)) return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(d, ksize, false).total;
  cudaError_t err = allow_smem(conv1d_bwd_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  conv1d_bwd_kernel<false><<<dim3((n + kTile - 1) / kTile, bh), kThreads, smem, stream>>>(
      nullptr, static_cast<const bf16*>(kern), static_cast<const bf16*>(g),
      static_cast<bf16*>(dv), nullptr, heads, n, d, ksize);
  return (int)cudaGetLastError();
}

// out[j] = sum over p < nparts of parts[p * count + j], fp32, in a fixed
// order: the backward's second pass (dkern from its partials), launched
// alone so the probe can time it.
MIRROR_EXPORT int mirror_column_sum(const void* parts, int nparts, long long count, void* out,
                                    cudaStream_t stream) {
  if (nparts <= 0 || count <= 0) return (int)cudaErrorInvalidValue;
  column_sum_kernel<float><<<column_sum_blocks(count), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(parts), nparts, count, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
