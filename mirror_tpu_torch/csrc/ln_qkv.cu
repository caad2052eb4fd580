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
// 227 KB and blocks run in no order, so every product here is a tiled GEMM
// on the shared mainloop of csrc/wmma_gemm.cuh (a block of 8 warps owns a
// 128 x 128 tile of the result and walks K in steps of 32 through a 4-stage
// cp.async ring; WMMA 16x16x16 bf16 with fp32 accumulation); this file
// gives each product its operand loaders and epilogue (LnQkvOps): the
// forward reads x (LN applied in shared memory when a
// stage lands, so y never reaches device memory) and w as they are and
// scatters its epilogue head-major; gy reads G through a head-major gather
// and w transposed (the shared tile keeps w's layout, the fragment reads it
// column-major); gw reads y transposed (LN applied on load again) against
// the gathered G, its long reduction over M split into a fixed number of
// fp32 partials that a second pass sums in order, so gw, like gs and gb
// (per-block column partials, summed in order), is the same from run to run.
// vit_gemm.cu's LN statistics are the two-pass variance; these are flax's
// fast variance (ln_stats_fast_kernel).
#include <algorithm>

#include "wmma_gemm.cuh"

namespace {

using wmma_gemm::BK;
using wmma_gemm::BM;
using wmma_gemm::BN;
using wmma_gemm::kThreads;
using wmma_gemm::kWarps;
using wmma_gemm::pack_bf16x8;
using wmma_gemm::unpack_bf16x8;

constexpr int kLnRows = 64;   // rows per block of the LN backward
constexpr int kMaxDim = 2048;
constexpr int kSplitRows = 2048;  // gw: at least this many rows per split

// The three products. A is [M, K] and B is [K, N] in GEMM terms.
enum Mode {
  kFwd = 0,    // A = LN(x) [rows, d], B = w [d, 3hdh] -> q, k, v head-major
  kGradY = 1,  // A = G [rows, 3hdh] (gather), B = w^T -> gy fp32 [rows, d]
  kGradW = 2,  // A = LN(x)^T [d, rows], B = G [rows, 3hdh] (gather) -> fp32 partial
};

struct Args {
  const bf16* x;
  float* mu;
  float* rstd;
  const float* s;
  const float* lb;
  const bf16* w;
  const bf16* g[3];  // gq, gk, gv (backward)
  bf16* out[3];      // q, k, v (forward)
  float* c;          // gy, or the gw partials
  int rows, d, n, heads, dh;
};

// t[which] for which in 0..2, without indexing the kernel's parameters at
// run time (which would copy them to local memory)
template <typename T>
__device__ __forceinline__ T pick(T t0, T t1, T t2, int which) {
  return which == 0 ? t0 : (which == 1 ? t1 : t2);
}

// Offset of element (row, c) of the head-major [3][b, h, n, dh] layout
// within tensor c / (h dh), and that tensor's index; 8 columns from c
// (c a multiple of 8, dh too) stay in one head.
__device__ __forceinline__ size_t head_major(const Args& a, int row, int c, int& which) {
  const int inner = a.heads * a.dh;
  which = c / inner;
  const int rem = c - which * inner, hh = rem / a.dh, e = rem - hh * a.dh;
  const int bi = row / a.n, i = row - bi * a.n;
  return ((size_t)(bi * a.heads + hh) * a.n + i) * a.dh + e;
}

// Per-row mean and 1 / sqrt(var + eps) of x [rows, d] with flax's fast
// variance, one warp a row.
__global__ void __launch_bounds__(kThreads)
    ln_stats_fast_kernel(const bf16* __restrict__ x, float* __restrict__ mu,
                         float* __restrict__ rstd, int rows, int d, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float v[8], sum = 0.f, sq = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), v);
    for (int t = 0; t < 8; ++t) {
      sum += v[t];
      sq += v[t] * v[t];
    }
  }
  const float mean = warp_sum(sum) / d;
  const float var = fmaxf(warp_sum(sq) / d - mean * mean, 0.f);
  if (lane == 0) {
    mu[row] = mean;
    rstd[row] = rsqrtf(var + eps);
  }
}

// The operands and the epilogue of each product, for wmma_gemm::gemm_tile.
// A chunk of x read as A is 8 features of one row: the LN prologue turns it
// into y = bf16((x - mu[row]) rstd[row] s[j] + b[j]), as _fwd_kernel rounds it.
template <int MODE>
struct LnQkvOps {
  static constexpr bool kAKContig = MODE != kGradW;  // else M-contiguous (y^T)
  static constexpr bool kBNContig = MODE != kGradY;  // else K-contiguous (w^T)
  static constexpr bool kPrologue = MODE != kGradY;  // the LN on x
  Args a;
  float* c;  // gy, or this split's gw partial [d, 3 h dh]

  __device__ const bf16* base() const { return a.x; }

  // element (row, col) of G [rows, 3 h dh], the head-major gather of g
  __device__ const bf16* gathered(int row, int col) const {
    int which;
    const size_t off = head_major(a, row, col, which);
    return pick(a.g[0], a.g[1], a.g[2], which) + off;
  }

  __device__ const bf16* a_chunk(int m, int k) const {
    if constexpr (MODE == kFwd)
      return a.x + (size_t)m * a.d + k;  // x [rows, d]
    else if constexpr (MODE == kGradY)
      return gathered(m, k);
    else
      return a.x + (size_t)k * a.d + m;  // x^T: m a feature, k a row
  }

  __device__ const bf16* b_chunk(int k, int n) const {
    const int n3 = 3 * a.heads * a.dh;
    if constexpr (MODE == kFwd)
      return a.w + (size_t)k * n3 + n;  // w [d, 3 h dh]
    else if constexpr (MODE == kGradY)
      return a.w + (size_t)n * n3 + k;  // w^T
    else
      return gathered(k, n);
  }

  __device__ void prologue(float* v, int m, int k) const {
    const int row = MODE == kFwd ? m : k, j = MODE == kFwd ? k : m;
    const float mu = a.mu[row], rs = a.rstd[row];
    for (int t = 0; t < 8; ++t) v[t] = (v[t] - mu) * rs * a.s[j + t] + a.lb[j + t];
  }

  __device__ void store(int m, int n, const float* v) const {
    if constexpr (MODE == kFwd) {
      int which;
      const size_t off = head_major(a, m, n, which);
      *reinterpret_cast<uint4*>(pick(a.out[0], a.out[1], a.out[2], which) + off) = pack_bf16x8(v);
    } else {
      const int ld = MODE == kGradY ? a.d : 3 * a.heads * a.dh;
      float4* dst = reinterpret_cast<float4*>(c + (size_t)m * ld + n);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
};

// One product over the K range [z k_split, (z + 1) k_split) of grid layer z
// (gw's split partials; the other products have one layer).
template <int MODE>
__global__ void __launch_bounds__(kThreads, 2) ln_qkv_gemm_kernel(Args a, int M, int N, int K,
                                                                  int k_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int k_begin = blockIdx.z * k_split;
  const LnQkvOps<MODE> ops{a, MODE == kGradW ? a.c + (size_t)blockIdx.z * M * N : a.c};
  wmma_gemm::gemm_tile(ops, *reinterpret_cast<wmma_gemm::Smem*>(smem_raw), M, N,
                       blockIdx.y * BM, blockIdx.x * BN, k_begin, min(K, k_begin + k_split));
}

// The LN backward over kLnRows rows a block, one warp a row: gx, and the
// block's column partials of gs = sum gy xhat and gb = sum gy (partial
// [blocks][2][d]), each summed in row order within a warp, then over the
// warps in order.
__global__ void __launch_bounds__(kThreads)
    ln_bwd_rows_kernel(const float* __restrict__ gy, const bf16* __restrict__ x,
                       const float* __restrict__ mu, const float* __restrict__ rstd,
                       const float* __restrict__ s, bf16* __restrict__ gx,
                       float* __restrict__ partial, int rows, int d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [kWarps][2][d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* gs_w = acc + (size_t)warp * 2 * d;
  float* gb_w = gs_w + d;
  for (int c = lane; c < 2 * d; c += 32) gs_w[c] = 0.f;
  __syncwarp();
  const int row0 = blockIdx.x * kLnRows;
  for (int r = row0 + warp; r < min(rows, row0 + kLnRows); r += kWarps) {
    const float m = mu[r], rs = rstd[r];
    const float* gyr = gy + (size_t)r * d;
    const bf16* xr = x + (size_t)r * d;
    float sum1 = 0.f, sum2 = 0.f, xv[8];
    for (int c = lane * 8; c < d; c += 256) {
      unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), xv);
      for (int t = 0; t < 8; ++t) {
        const float g = gyr[c + t], xhat = (xv[t] - m) * rs, gxhat = g * s[c + t];
        sum1 += gxhat;
        sum2 += gxhat * xhat;
        gs_w[c + t] += g * xhat;
        gb_w[c + t] += g;
      }
    }
    const float m1 = warp_sum(sum1) / d, m2 = warp_sum(sum2) / d;
    for (int c = lane * 8; c < d; c += 256) {
      unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), xv);
      float out[8];
      for (int t = 0; t < 8; ++t) {
        const float xhat = (xv[t] - m) * rs, gxhat = gyr[c + t] * s[c + t];
        out[t] = rs * (gxhat - m1 - xhat * m2);
      }
      *reinterpret_cast<uint4*>(gx + (size_t)r * d + c) = pack_bf16x8(out);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d; c += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += acc[(size_t)w * 2 * d + c];
    partial[(size_t)blockIdx.x * 2 * d + c] = sum;
  }
}

size_t gemm_smem() { return sizeof(wmma_gemm::Smem); }

// gw's split of its M-row reduction: enough blocks for two waves of 132
// SMs, at least kSplitRows rows a split.
int gw_splits(int rows, int d, int n3) {
  const int tiles = ((d + BM - 1) / BM) * ((n3 + BN - 1) / BN);
  const int want = (2 * 132 + tiles - 1) / tiles;
  return std::max(1, std::min(want, rows / kSplitRows));
}

int gw_split_rows(int rows, int splits) {
  const int steps = (rows + BK - 1) / BK;
  return (steps + splits - 1) / splits * BK;
}

int ln_blocks(int rows) { return (rows + kLnRows - 1) / kLnRows; }

// Scratch segments start on 256-byte boundaries (the fp32 epilogues store 16
// bytes at a time).
long long aligned(long long elems) { return (elems + 63) / 64 * 64; }

template <int MODE>
cudaError_t launch_gemm(const Args& a, int M, int N, int K, int splits, int k_split,
                        cudaStream_t stream) {
  const cudaError_t err = allow_smem(ln_qkv_gemm_kernel<MODE>, gemm_smem());
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  ln_qkv_gemm_kernel<MODE><<<grid, kThreads, gemm_smem(), stream>>>(a, M, N, K, k_split);
  return cudaGetLastError();
}

bool valid(int bsz, int n, int d, int heads, int dh) {
  return bsz > 0 && n > 0 && d > 0 && d % 8 == 0 && d <= kMaxDim && heads > 0 && dh > 0 &&
         dh % 8 == 0;
}

Args make_args(const void* x, const void* s, const void* lb, const void* w, float* stats,
               int bsz, int n, int d, int heads, int dh) {
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.rows = bsz * n;
  a.mu = stats;
  a.rstd = stats + a.rows;
  a.s = static_cast<const float*>(s);
  a.lb = static_cast<const float*>(lb);
  a.w = static_cast<const bf16*>(w);
  a.d = d;
  a.n = n;
  a.heads = heads;
  a.dh = dh;
  return a;
}

cudaError_t launch_stats(const Args& a, float eps, cudaStream_t stream) {
  ln_stats_fast_kernel<<<(a.rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      a.x, a.mu, a.rstd, a.rows, a.d, eps);
  return cudaGetLastError();
}

}  // namespace

// Forward. x bf16 [bsz, n, d]; s, lb fp32 [d]; w bf16 [d, 3 heads dh];
// q, k, v bf16 [bsz, heads, n, dh]; stats fp32 scratch [2, bsz n] (mean,
// rstd). d a multiple of 8 up to 2048, dh a multiple of 8.
MIRROR_EXPORT int mirror_ln_qkv(const void* x, const void* s, const void* lb, const void* w,
                                void* q, void* k, void* v, void* stats, int bsz, int n, int d,
                                int heads, int dh, float eps, cudaStream_t stream) {
  if (!valid(bsz, n, d, heads, dh)) return (int)cudaErrorInvalidValue;
  Args a = make_args(x, s, lb, w, static_cast<float*>(stats), bsz, n, d, heads, dh);
  a.out[0] = static_cast<bf16*>(q);
  a.out[1] = static_cast<bf16*>(k);
  a.out[2] = static_cast<bf16*>(v);
  cudaError_t err = launch_stats(a, eps, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm<kFwd>(a, a.rows, 3 * heads * dh, d, 1, d, stream);
}

// Elements of the fp32 scratch that mirror_ln_qkv_bwd needs: the LN
// statistics [2, rows], gy [rows, d], the gw partials [splits, d, 3 h dh]
// and the gs/gb partials [blocks, 2, d].
MIRROR_EXPORT long long mirror_ln_qkv_bwd_scratch_elems(int bsz, int n, int d, int heads,
                                                        int dh) {
  const long long rows = (long long)bsz * n, n3 = 3LL * heads * dh;
  return aligned(2 * rows) + aligned(rows * d) + aligned(gw_splits((int)rows, d, (int)n3) * d * n3) +
         2LL * ln_blocks((int)rows) * d;
}

// Backward. gq, gk, gv bf16 [bsz, heads, n, dh]; gx bf16 [bsz, n, d]; gw
// bf16 [d, 3 heads dh]; gsb fp32 [2, d] (gs, then gb); scratch fp32 of
// mirror_ln_qkv_bwd_scratch_elems(...) elements.
MIRROR_EXPORT int mirror_ln_qkv_bwd(const void* x, const void* s, const void* lb, const void* w,
                                    const void* gq, const void* gk, const void* gv, void* gx,
                                    void* gw, void* gsb, void* scratch, int bsz, int n, int d,
                                    int heads, int dh, float eps, cudaStream_t stream) {
  if (!valid(bsz, n, d, heads, dh)) return (int)cudaErrorInvalidValue;
  float* stats = static_cast<float*>(scratch);
  Args a = make_args(x, s, lb, w, stats, bsz, n, d, heads, dh);
  a.g[0] = static_cast<const bf16*>(gq);
  a.g[1] = static_cast<const bf16*>(gk);
  a.g[2] = static_cast<const bf16*>(gv);
  const int rows = a.rows, n3 = 3 * heads * dh;
  const int splits = gw_splits(rows, d, n3);
  float* gy = stats + aligned(2LL * rows);
  float* gw_part = gy + aligned((long long)rows * d);
  float* ln_part = gw_part + aligned((long long)splits * d * n3);

  cudaError_t err = launch_stats(a, eps, stream);
  if (err != cudaSuccess) return (int)err;
  a.c = gy;
  err = launch_gemm<kGradY>(a, rows, d, n3, 1, n3, stream);
  if (err != cudaSuccess) return (int)err;
  a.c = gw_part;
  err = launch_gemm<kGradW>(a, d, n3, rows, splits, gw_split_rows(rows, splits), stream);
  if (err != cudaSuccess) return (int)err;
  const long long gw_count = (long long)d * n3;
  column_sum_kernel<bf16><<<column_sum_blocks(gw_count), dim3(32, 8), 0, stream>>>(
      gw_part, splits, gw_count, static_cast<bf16*>(gw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t ln_smem = (size_t)kWarps * 2 * d * sizeof(float);
  err = allow_smem(ln_bwd_rows_kernel, ln_smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = ln_blocks(rows);
  ln_bwd_rows_kernel<<<blocks, kThreads, ln_smem, stream>>>(
      gy, a.x, a.mu, a.rstd, a.s, static_cast<bf16*>(gx), ln_part, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sum_kernel<float><<<column_sum_blocks(2LL * d), dim3(32, 8), 0, stream>>>(
      ln_part, blocks, 2LL * d, static_cast<float*>(gsb));
  return (int)cudaGetLastError();
}
