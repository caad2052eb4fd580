// The standalone depthwise conv along the sequence (K9) and its backward
// (K9b): dv and dkern in one pass over g and v.
//
// Replaces: mirror_tpu/ops/conv1d_pallas.py::depthwise_conv1d_seq, the
// forward pallas_call of _fwd_call (_banded_kernel) and the backward one of
// _bwd_call (_bwd_kernel). For the probe scripts/exp_conv_parts.py (K11f),
// which times those two, the backward's dv alone (the forward's kernel on g
// with the taps flipped) and its second pass alone (mirror_column_sum) are
// entries too. Kernel 4's forward (softmax_attn.cu) carries the same conv
// fused into its attention tail; its backward (softmax_attn_bwd.cu)
// launches this file's backward through conv1d.cuh.
//
// What it computes, per (batch, head) of v [b, h, n, d] bf16 with one filter
// of K taps per head (kern [h, K], K odd, bf16: the wrapper rounds fp32 taps
// as the TPU kernel does when it builds its band in v's dtype):
// out[i] = sum_t kern[t] v[i + t - K/2], zero SAME padding, no bias, an fp32
// sum rounded once. The backward takes g in v's dtype and emits
// dv[i] = sum_t kern[t] g[i - t + K/2] (the same conv with the taps flipped,
// rounded once) and dkern[h, t] = sum over batch, rows and features of
// g[i] v[i + t - K/2] in fp32 (bf16 x bf16 products are exact in fp32).
//
// Design: the TPU's banded products, on mma.sync m16n8k16 (attn_mma.cuh).
// - Rows. A block owns a chunk of whole 64-row steps of one (batch, head)
//   (conv_plan: as many chunks as keep the grid within one wave of the
//   backward, so it fills the SMs) and streams it through a ring of
//   kStages stages of 64 rows, loaded by cp.async 16 bytes a thread into
//   rows padded to d + 8 (the 8 rows of an ldmatrix fall in 8 bank groups;
//   no swizzle), rows outside [0, n) zero-filled, so n <= K/2 and a short
//   last step need no case of their own. Chunk row c holds sequence row s0 64 - K/2 + c; step
//   k reads chunk rows [64 k, 64 k + 48 + W) (stages k and k + 1), and the
//   K - 1 halo rows of a step are the next step's own: only a chunk's ends
//   read a halo (W - 16 rows of one more stage).
// - The conv (the forward, dv, dv alone): warp w's 16 output rows of a step
//   are Band[16, W] . window[64 k + 16 w + j, :], j < W, where Band[r, j] =
//   tap[j - r] for 0 <= j - r < K and W = 16 + K - 1 rounded up to 16 (48
//   at K 33, 80 at K 65). The band is the same for every warp and step, so
//   its A fragments are built once from the taps and stay in registers; B
//   comes from the ring by ldmatrix.trans. W MACs an output (48 at K 33)
//   against K useful; each output is one fp32 accumulation over the W / 16
//   k-steps, rounded once to bf16, staged by 16-column pairs in the warp's
//   own tile and stored 16 bytes a lane, a row's 32-byte sector whole in
//   one instruction.
// - dkern (the fused backward): with i = i0 + 16 w + r, warp w takes the
//   Toeplitz product C[r, s] = sum_f g[i0 + 16 w + r, f] v[i0 + 16 w + s -
//   K/2, f], s < W: an NT product of M 16, N W and depth d (features padded
//   to 16 by the zeroed pad columns), both operands by ldmatrix from the
//   two rings. A step's C goes into an fp32 register sum (so no mma chain
//   runs longer than d / 16 k-steps), and at the chunk's end dkern's block
//   partial is partial[t] = sum over w in order, then r in order, of
//   Csum_w[r, r + t], from the sums staged in shared memory. At K 33, 33 of
//   the 48 columns of s are taps (69 %).
// - dkern's order, fixed: the partials are laid out [b chunks, h K] and
//   launch_column_sum (common.cuh) adds them in its documented order, so
//   two runs agree bit for bit; dv alone runs the forward's kernel on g
//   with the flipped taps, the fused kernel's very products, so it is the
//   fused dv bit for bit.
//
// What bounds it on the H100: at [16, 8, 2117, 96] with K 33 the forward
// reads and writes 2 bytes an element (52 + 52 MB, 31 us at 3.35 TB/s)
// against K = 33 useful MACs an element on the tensor cores (2 us at 989
// TFLOP/s; the design runs W = 48); the backward reads g and v and writes
// dv (156 MB, 47 us) against 2 x 33: bytes, both. Counted as fp32 FMAs (2 K
// FLOP an element, the design this one replaced), the backward's operations
// alone took 51 us at 67 TFLOP/s.
//
// Tried on the card (exp_conv_parts, H100 80GB HBM3 at 700 W; PERF.md):
// - The design this one replaced: a thread slid two features down a haloed
//   132-row window with a ring of 11 rows in registers, the taps as fp32
//   FMAs (CUDA cores); dkern was the same slide with g and v swapped, summed
//   per thread in shared memory and then by 33 of 192 threads one after
//   another. 9b ran at 17 % of its bound.
// - This design with the outputs stored straight from the accumulator
//   fragments (4 bytes a lane, a 16-byte piece of 8 rows an instruction):
//   the forward no faster than the slide, both near half the HBM rate; staging
//   them for whole-sector stores made the forward 1.5x and 9b 1.2x faster.
// - No gain, not kept: the carveout set to the most shared memory; an L2
//   bulk prefetch of the stages 2 to 4 ahead of the ring (slower); a whole
//   [16, d] row tile staged per warp for full-line stores (one block an SM
//   fewer); the feature loops unrolled by 2; twice the chunks (two waves of
//   the backward). The kernels now run at the rate of the repository's
//   streaming copy (csrc/copy_floor.cu).
#include "attn_mma.cuh"
#include "conv1d.cuh"

namespace {

using attn::ldsm_x4;
using attn::ldsm_x4_t;
using attn::mma16816;
using attn::pack_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 16 * kWarps;           // rows a step: 16 a warp
constexpr int kStages = 4;                   // ring stages of kStep rows
constexpr int kRingRows = kStages * kStep;   // a power of two: rows wrap by a mask
constexpr int kWaveBlocks = 264;             // one wave of the backward: 2 blocks an SM, 132 SMs
constexpr int kMaxTaps = 65;
constexpr int kMaxDim = 128;

// W / 16: the band's (and the Toeplitz product's) 16-column tiles, 16 + K -
// 1 rounded up to 16 (1 at K 1, 2 up to K 17, 3 up to K 33, 5 at K 65).
__host__ __device__ constexpr int band_tiles(int ksize) { return (ksize + 30) / 16; }

struct Plan {
  int steps_per_chunk, chunks;
};

// The rows of one (batch, head) in chunks of whole steps: the most chunks
// that keep b h chunks within one wave of the backward (kWaveBlocks; at
// least one chunk, at most one a step), each of ceil(steps / chunks) steps,
// the last one shorter. One wave: a block's ring fills once, and no block
// of a second wave waits on the tail of the first (two waves ran 9b slower
// at [16, 8, 2117, 96] in exp_conv_parts).
Plan conv_plan(int bh, int n) {
  const int steps = (n + kStep - 1) / kStep;
  const int fit = kWaveBlocks / bh > 1 ? kWaveBlocks / bh : 1;
  const int chunks = fit < steps ? fit : steps;
  const int per = (steps + chunks - 1) / chunks;
  return {per, (steps + per - 1) / per};
}

// Shared memory: the taps (bf16), each warp's [16, 16] bf16 output staging
// tile, then the ring of src (the forward) or the rings of g and v (the
// backward), which dkern's epilogue reuses for the warps' [16, 16 WT] fp32
// sums (more than the rings at d 8).
constexpr size_t kTapBytes = smem_align(kMaxTaps * sizeof(bf16));
constexpr size_t kStageBytes = kWarps * 16 * 16 * sizeof(bf16);
constexpr size_t kHeadBytes = kTapBytes + kStageBytes;  // where the rings start

__host__ __device__ size_t ring_bytes(int d) {
  return smem_align((size_t)kRingRows * (d + 8) * sizeof(bf16));
}

size_t smem_bytes(int d, bool dkern, int wt) {
  if (!dkern) return kHeadBytes + ring_bytes(d);
  const size_t rings = 2 * ring_bytes(d), sums = (size_t)kWarps * 16 * 16 * wt * sizeof(float);
  return kHeadBytes + (rings > sums ? rings : sums);
}

__device__ __forceinline__ int ring_row(int c) { return c & (kRingRows - 1); }

// Stage st of the chunk: ring rows of chunk rows [kStep st, kStep st + rows)
// <- sequence rows row0 + kStep st + r of a [n, d] matrix, zeros outside
// [0, n); 16 bytes a thread, one cp.async group per stage (the caller
// commits).
__device__ __forceinline__ void load_stage(bf16* ring, int ld, const bf16* src, int row0,
                                           int st, int rows, int n, int d) {
  const int chunks = d / 8;
  const int base = (st % kStages) * kStep;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const int gr = row0 + st * kStep + r;
    const bool ok = gr >= 0 && gr < n;
    cp_async16(ring + (base + r) * ld + c, ok ? src + (size_t)gr * d + c : src, ok);
  }
}

// The pad columns d .. d + 7 of every ring row, zeroed once: the k-padding of
// dkern's features and the unused half of the conv's last n-tile pair when
// d % 16 == 8 (cp.async never writes them).
__device__ __forceinline__ void zero_pad(bf16* ring, int ld, int d) {
  for (int r = threadIdx.x; r < kRingRows; r += kThreads)
    *reinterpret_cast<uint4*>(ring + r * ld + d) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The A fragments of Band[16, 16 WT] (Band[r, j] = tap[j - r] for 0 <= j - r
// < K, else 0), from the K taps in shared memory.
template <int WT>
__device__ __forceinline__ void band_frags(unsigned (&a)[WT][4], const bf16* sTap, int ksize) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bf16 zero = __float2bfloat16(0.f);
  auto tap = [&](int r, int j) {
    const int x = j - r;
    return x >= 0 && x < ksize ? sTap[x] : zero;
  };
#pragma unroll
  for (int kk = 0; kk < WT; ++kk) {
    const int j = 16 * kk + 2 * t;
    a[kk][0] = pack2(tap(g, j), tap(g, j + 1));
    a[kk][1] = pack2(tap(g + 8, j), tap(g + 8, j + 1));
    a[kk][2] = pack2(tap(g, j + 8), tap(g, j + 9));
    a[kk][3] = pack2(tap(g + 8, j + 8), tap(g + 8, j + 9));
  }
}

// The warp's 16 output rows of a step: out[i0 + r] = sum_j Band[r, j]
// window[c0 + j] for window chunk rows c0 = 64 k + 16 w on; one n-tile pair
// (16 features) at a time, rounded to bf16 and staged in the warp's [16, 16]
// tile, so that each lane stores 16 bytes and a row's 32 bytes (a whole
// sector) go out in one instruction (stored from the fragments, a 16-byte
// piece of 8 rows an instruction, the conv ran at half the HBM rate); rows
// past n and the pad columns are skipped.
template <int WT>
__device__ __forceinline__ void band_step(const unsigned (&a)[WT][4], const bf16* ring, int ld,
                                          int c0, bf16* stage, bf16* out, int i0, int n,
                                          int d) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int lrow = (lane % 8) + ((lane / 8) % 2) * 8, lcol = (lane / 16) * 8;
  const int srow = lane / 2, shalf = lane % 2;  // the 16 bytes this lane stores
  for (int np = 0; np < (d + 15) / 16; ++np) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < WT; ++kk) {
      unsigned fb[4];
      ldsm_x4_t(fb, ring + ring_row(c0 + 16 * kk + lrow) * ld + 16 * np + lcol);
      mma16816(acc[0], a[kk], fb[0], fb[1]);
      mma16816(acc[1], a[kk], fb[2], fb[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<unsigned*>(stage + g * 16 + 8 * h + 2 * t) =
          pack_bf16(acc[h][0], acc[h][1]);
      *reinterpret_cast<unsigned*>(stage + (g + 8) * 16 + 8 * h + 2 * t) =
          pack_bf16(acc[h][2], acc[h][3]);
    }
    __syncwarp();
    const int col = 16 * np + 8 * shalf;
    if (i0 + srow < n && col < d)
      *reinterpret_cast<uint4*>(out + (size_t)(i0 + srow) * d + col) =
          *reinterpret_cast<const uint4*>(stage + srow * 16 + 8 * shalf);
    __syncwarp();
  }
}

// The conv of one ring: out = conv(src, taps), the forward (kern as it is)
// and dv alone (src = g, the taps flipped).
template <int WT>
__global__ void __launch_bounds__(kThreads)
    conv1d_kernel(const bf16* __restrict__ src, const bf16* __restrict__ kern,
                  bf16* __restrict__ out, int heads, int n, int d, int ksize, int flip,
                  int steps_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + 8;
  bf16* sTap = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + kHeadBytes);
  const int bh = blockIdx.y, warp = threadIdx.x / 32;
  bf16* stage = reinterpret_cast<bf16*>(smem + kTapBytes) + warp * 16 * 16;
  const int steps = (n + kStep - 1) / kStep, s0 = blockIdx.x * steps_per_chunk;
  const int ns = min(steps_per_chunk, steps - s0), row0 = s0 * kStep - ksize / 2;
  const int last_rows = 16 * WT - 16;  // the last stage: the halo of step ns - 1
  const size_t base = (size_t)bh * n * d;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st <= ns) load_stage(ring, ld, src + base, row0, st, st < ns ? kStep : last_rows, n, d);
    cp_async_commit();
  }
  zero_pad(ring, ld, d);
  for (int t = threadIdx.x; t < ksize; t += kThreads)
    sTap[t] = kern[(bh % heads) * ksize + (flip ? ksize - 1 - t : t)];
  __syncthreads();
  unsigned a[WT][4];
  band_frags<WT>(a, sTap, ksize);
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<kStages - 3>();
    __syncthreads();
    const int st = k + kStages - 1;
    if (st <= ns) load_stage(ring, ld, src + base, row0, st, st < ns ? kStep : last_rows, n, d);
    cp_async_commit();
    band_step<WT>(a, ring, ld, kStep * k + 16 * warp, stage, out + base,
                  (s0 + k) * kStep + 16 * warp, n, d);
  }
}

// dv (the band product on g with the flipped taps, as conv1d_kernel) and
// the block's dkern partial (the Toeplitz product of g and v), over one
// chunk: partial[(b chunks + chunk) h K + h K + t].
template <int WT>
__global__ void __launch_bounds__(kThreads)
    conv1d_bwd_kernel(const bf16* __restrict__ v, const bf16* __restrict__ kern,
                      const bf16* __restrict__ g, bf16* __restrict__ dv,
                      float* __restrict__ partial, int heads, int n, int d, int ksize,
                      int steps_per_chunk) {
  constexpr int NT = 2 * WT;  // n8 tiles of s
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + 8, half = ksize / 2;
  bf16* sTap = reinterpret_cast<bf16*>(smem);
  bf16* gring = reinterpret_cast<bf16*>(smem + kHeadBytes);
  bf16* vring = reinterpret_cast<bf16*>(smem + kHeadBytes + ring_bytes(d));
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* stage = reinterpret_cast<bf16*>(smem + kTapBytes) + warp * 16 * 16;
  const int steps = (n + kStep - 1) / kStep, s0 = blockIdx.x * steps_per_chunk;
  const int ns = min(steps_per_chunk, steps - s0), row0 = s0 * kStep - half;
  const int last_rows = 16 * WT - 16;
  const size_t base = (size_t)bh * n * d;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st <= ns) {
      const int rows = st < ns ? kStep : last_rows;
      load_stage(gring, ld, g + base, row0, st, rows, n, d);
      load_stage(vring, ld, v + base, row0, st, rows, n, d);
    }
    cp_async_commit();
  }
  zero_pad(gring, ld, d);
  zero_pad(vring, ld, d);
  for (int t = threadIdx.x; t < ksize; t += kThreads)
    sTap[t] = kern[(bh % heads) * ksize + ksize - 1 - t];
  __syncthreads();
  unsigned a[WT][4];
  band_frags<WT>(a, sTap, ksize);

  float csum[NT][4] = {};
  // ldmatrix lane offsets: the A rows of g (16 rows, two k halves), the B
  // rows of v (NT rows of s in pairs, two k halves)
  const int arow = lane % 16, acol = (lane / 16) * 8;
  const int brow = (lane % 8) + (lane / 16) * 8, bcol = ((lane / 8) % 2) * 8;
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<kStages - 3>();
    __syncthreads();
    const int st = k + kStages - 1;
    if (st <= ns) {
      const int rows = st < ns ? kStep : last_rows;
      load_stage(gring, ld, g + base, row0, st, rows, n, d);
      load_stage(vring, ld, v + base, row0, st, rows, n, d);
    }
    cp_async_commit();
    const int c0 = kStep * k + 16 * warp;
    band_step<WT>(a, gring, ld, c0, stage, dv + base, (s0 + k) * kStep + 16 * warp, n, d);

    // C[r, s] += g[c0 + half + r] . v[c0 + s] over the features
    float c[NT][4] = {};
    for (int f = 0; f < (d + 15) / 16; ++f) {
      unsigned fa[4];
      ldsm_x4(fa, gring + ring_row(c0 + half + arow) * ld + 16 * f + acol);
#pragma unroll
      for (int sp = 0; sp < WT; ++sp) {
        unsigned fb[4];
        ldsm_x4(fb, vring + ring_row(c0 + 16 * sp + brow) * ld + 16 * f + bcol);
        mma16816(c[2 * sp], fa, fb[0], fb[1]);
        mma16816(c[2 * sp + 1], fa, fb[2], fb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) csum[j][e] += c[j][e];
  }

  // dkern's block partial: the warps' sums staged as [warp][16][16 WT] fp32
  // over the (now idle) rings, then partial[t] = sum over w, then r, in order
  cp_async_wait<0>();
  __syncthreads();
  float* sC = reinterpret_cast<float*>(gring);
  {
    const int gq = lane / 4, tq = lane % 4;
    float* mine = sC + warp * 16 * (16 * WT);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mine[gq * 16 * WT + 8 * j + 2 * tq] = csum[j][0];
      mine[gq * 16 * WT + 8 * j + 2 * tq + 1] = csum[j][1];
      mine[(gq + 8) * 16 * WT + 8 * j + 2 * tq] = csum[j][2];
      mine[(gq + 8) * 16 * WT + 8 * j + 2 * tq + 1] = csum[j][3];
    }
  }
  __syncthreads();
  const int b = bh / heads, h = bh % heads;
  float* out = partial + (((size_t)b * gridDim.x + blockIdx.x) * heads + h) * ksize;
  for (int t = threadIdx.x; t < ksize; t += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w)
      for (int r = 0; r < 16; ++r) sum += sC[(w * 16 + r) * 16 * WT + r + t];
    out[t] = sum;
  }
}

bool valid(int bh, int heads, int n, int d, int ksize) {
  return bh > 0 && heads > 0 && bh % heads == 0 && n > 0 && d > 0 && d % 8 == 0 &&
         d <= kMaxDim && ksize > 0 && ksize % 2 == 1 && ksize <= kMaxTaps;
}

template <int WT>
cudaError_t launch_conv(const bf16* src, const bf16* kern, bf16* out, int bh, int heads, int n,
                        int d, int ksize, bool flip, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, false, WT);
  cudaError_t err = allow_smem(conv1d_kernel<WT>, smem);
  if (err != cudaSuccess) return err;
  const Plan p = conv_plan(bh, n);
  conv1d_kernel<WT><<<dim3(p.chunks, bh), kThreads, smem, stream>>>(
      src, kern, out, heads, n, d, ksize, flip ? 1 : 0, p.steps_per_chunk);
  return cudaGetLastError();
}

template <int WT>
cudaError_t launch_conv_bwd(const bf16* v, const bf16* kern, const bf16* g, bf16* dv,
                            float* partial, int bh, int heads, int n, int d, int ksize,
                            cudaStream_t stream) {
  const size_t smem = smem_bytes(d, true, WT);
  cudaError_t err = allow_smem(conv1d_bwd_kernel<WT>, smem);
  if (err != cudaSuccess) return err;
  const Plan p = conv_plan(bh, n);
  conv1d_bwd_kernel<WT><<<dim3(p.chunks, bh), kThreads, smem, stream>>>(
      v, kern, g, dv, partial, heads, n, d, ksize, p.steps_per_chunk);
  return cudaGetLastError();
}

cudaError_t conv(const bf16* src, const bf16* kern, bf16* out, int bh, int heads, int n, int d,
                 int ksize, bool flip, cudaStream_t stream) {
  if (!valid(bh, heads, n, d, ksize)) return cudaErrorInvalidValue;
  cudaError_t (*launch)(const bf16*, const bf16*, bf16*, int, int, int, int, int, bool,
                        cudaStream_t);
  switch (band_tiles(ksize)) {
    case 1: launch = launch_conv<1>; break;
    case 2: launch = launch_conv<2>; break;
    case 3: launch = launch_conv<3>; break;
    case 4: launch = launch_conv<4>; break;
    default: launch = launch_conv<5>;
  }
  return launch(src, kern, out, bh, heads, n, d, ksize, flip, stream);
}

}  // namespace

long long conv1d_bwd_partial_elems(int bh, int n, int ksize) {
  return (long long)bh * conv_plan(bh, n).chunks * ksize;
}

cudaError_t conv1d_bwd(const bf16* v, const bf16* kern, const bf16* g, bf16* dv, float* dkern,
                       float* partial, int bh, int heads, int n, int d, int ksize,
                       cudaStream_t stream) {
  if (!valid(bh, heads, n, d, ksize)) return cudaErrorInvalidValue;
  cudaError_t (*launch)(const bf16*, const bf16*, const bf16*, bf16*, float*, int, int, int,
                        int, int, cudaStream_t);
  switch (band_tiles(ksize)) {
    case 1: launch = launch_conv_bwd<1>; break;
    case 2: launch = launch_conv_bwd<2>; break;
    case 3: launch = launch_conv_bwd<3>; break;
    case 4: launch = launch_conv_bwd<4>; break;
    default: launch = launch_conv_bwd<5>;
  }
  cudaError_t err = launch(v, kern, g, dv, partial, bh, heads, n, d, ksize, stream);
  if (err != cudaSuccess) return err;
  // dkern[h, t] = the column sum of the partials over batch and chunks
  return launch_column_sum(partial, bh / heads * conv_plan(bh, n).chunks,
                           (long long)heads * ksize, dkern, stream);
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
  return (int)conv(static_cast<const bf16*>(v), static_cast<const bf16*>(kern),
                   static_cast<bf16*>(out), bh, heads, n, d, ksize, false, stream);
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
  return (int)conv(static_cast<const bf16*>(g), static_cast<const bf16*>(kern),
                   static_cast<bf16*>(dv), bh, heads, n, d, ksize, true, stream);
}

// out[j] = sum over p < nparts of parts[p * count + j], fp32, in
// launch_column_sum's fixed order: the backward's second pass (dkern from
// its partials), launched alone so the probe can time it.
MIRROR_EXPORT int mirror_column_sum(const void* parts, int nparts, long long count, void* out,
                                    cudaStream_t stream) {
  return (int)launch_column_sum(static_cast<const float*>(parts), nparts, count,
                                static_cast<float*>(out), stream);
}
