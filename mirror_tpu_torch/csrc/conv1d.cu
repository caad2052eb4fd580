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
//
// Element types (attn_mma.cuh): v, the taps, g, out and dv are one type T,
// bf16 (the sentences above), float16 or float32; sums are fp32 and each
// output is rounded to T once. float16 is bf16's design with .f16 operands;
// float32 runs the band and Toeplitz products in the 3xTF32 split (its taps
// are not exact in tf32, so they are split too). A float32 ring of 256
// rows of d + 8 takes 106 KB at d 96; two (the backward) fit a block's
// 227 KB up to d 96, so above that the backward splits the features into
// two parts, each block one part (the grid's z): dv's columns and dkern's
// feature sums are cut along them, the partials laid out [b chunks parts,
// h K], so the column sum adds the parts in its fixed order too. The bf16
// and float16 backwards take one part.
//
// Any d (the forward and dv alone): a d above kMaxDim is cut into feature
// parts of kMaxDim columns, one a block (the grid's z), each convolved on
// its own; rows that are not whole 16-byte pieces (d % 8 != 0 in the
// 16-bit types) load into the ring and store element by element.
#include "attn_mma.cuh"
#include "conv1d.cuh"

namespace {

using attn::AFrag;
using attn::AOp;
using attn::BFrag;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 16 * kWarps;           // rows a step: 16 a warp
constexpr int kStages = 4;                   // ring stages of kStep rows
constexpr int kRingRows = kStages * kStep;   // a power of two: rows wrap by a mask
constexpr int kWaveBlocks = 264;             // one wave of the backward: 2 blocks an SM, 132 SMs
constexpr int kMaxTaps = 65;
constexpr int kMaxDim = 128;
constexpr size_t kMaxSmem = 232448;          // a block's shared memory on the H100

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

// Shared memory: the taps (T), each warp's [16, 16] output staging tile
// (T), then the ring of src (the forward) or the rings of g and v (the
// backward), rows of `cols` + 8 elements, which dkern's epilogue reuses for
// the warps' [16, 16 WT] fp32 sums (more than the rings at d 8).
template <typename T>
__host__ __device__ constexpr size_t tap_bytes() { return smem_align(kMaxTaps * sizeof(T)); }
template <typename T>
__host__ __device__ constexpr size_t head_bytes() {  // where the rings start
  return tap_bytes<T>() + kWarps * 16 * 16 * sizeof(T);
}

template <typename T>
__host__ __device__ size_t ring_bytes(int cols) {
  return smem_align((size_t)kRingRows * (cols + 8) * sizeof(T));
}

template <typename T>
size_t smem_bytes(int cols, bool dkern, int wt) {
  if (!dkern) return head_bytes<T>() + ring_bytes<T>(cols);
  const size_t rings = 2 * ring_bytes<T>(cols), sums = (size_t)kWarps * 16 * 16 * wt * sizeof(float);
  return head_bytes<T>() + (rings > sums ? rings : sums);
}

// The backward's feature parts: one, or two when its rings of d columns
// would not fit a block (float32 above d 96); and the columns of a part, a
// multiple of 8 (the last part may be shorter).
struct Parts {
  int parts, cols;
};

template <typename T>
Parts feature_parts(int d, int wt) {
  if (smem_bytes<T>(d, true, wt) <= kMaxSmem) return {1, d};
  const int cols = ((d + 1) / 2 + 7) / 8 * 8;
  return {(d + cols - 1) / cols, cols};
}

__device__ __forceinline__ int ring_row(int c) { return c & (kRingRows - 1); }

// The forward's ring row stride for a part of pcols columns: pcols rounded
// up to 8, plus the 8 pad columns (d + 8 at every d the backward takes).
__host__ __device__ constexpr int fwd_row(int pcols) { return (pcols + 7) / 8 * 8 + 8; }

// Stage st of the chunk: ring rows of chunk rows [kStep st, kStep st + rows)
// <- columns [0, cols) of sequence rows row0 + kStep st + r of a [n, d]
// matrix (src at the part's first column), zeros outside [0, n); 16 bytes a
// thread, one cp.async group per stage (the caller commits).
// A d that is not a whole number of 16-byte pieces (a forward's rows are
// then not 16-byte aligned) loads element by element, synchronously, every
// column of the ring row, zeros past cols (the ring's order still holds: a
// stage is written only after the __syncthreads that frees it).
template <typename T>
__device__ __forceinline__ void load_stage(T* ring, int ld, const T* src, int row0, int st,
                                           int rows, int n, int cols, int d) {
  constexpr int V = vec16<T>();
  const int base = (st % kStages) * kStep;
  if (d % V != 0) {  // attn::kLoadAhead loads in flight a thread, then their stores
    constexpr int U = attn::kLoadAhead;
    const T zero = Elem<T>::from_float(0.f);
    for (int first = threadIdx.x; first < rows * ld; first += U * kThreads) {
      T x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = first + u * kThreads, r = idx / ld, c = idx % ld;
        const int gr = row0 + st * kStep + r;
        x[u] = idx < rows * ld && gr >= 0 && gr < n && c < cols ? src[(size_t)gr * d + c] : zero;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = first + u * kThreads;
        if (idx < rows * ld) ring[(base + idx / ld) * ld + idx % ld] = x[u];
      }
    }
    return;
  }
  const int chunks = cols / V;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * V;
    const int gr = row0 + st * kStep + r;
    const bool ok = gr >= 0 && gr < n;
    cp_async16(ring + (base + r) * ld + c, ok ? src + (size_t)gr * d + c : src, ok);
  }
}

// The pad columns cols .. ld - 1 of every ring row, zeroed once: the
// k-padding of dkern's features and the unused half of the conv's last
// n-tile pair when cols % 16 == 8 (cp.async never writes them).
template <typename T>
__device__ __forceinline__ void zero_pad(T* ring, int ld, int cols) {
  constexpr int V = vec16<T>();
  const int pieces = (ld - cols) / V;
  for (int i = threadIdx.x; i < kRingRows * pieces; i += kThreads)
    *reinterpret_cast<uint4*>(ring + (i / pieces) * ld + cols + (i % pieces) * V) =
        make_uint4(0u, 0u, 0u, 0u);
}

// The A fragments of Band[16, 16 WT] (Band[r, j] = tap[j - r] for 0 <= j - r
// < K, else 0), from the K taps in shared memory.
template <int WT, typename T>
__device__ __forceinline__ void band_frags(AFrag<T> (&a)[WT], const T* sTap, int ksize) {
#pragma unroll
  for (int kk = 0; kk < WT; ++kk)
    a[kk] = attn::afrag_from<T>([&](int r, int j) {
      const int x = 16 * kk + j - r;
      return x >= 0 && x < ksize ? Elem<T>::to_float(sTap[x]) : 0.f;
    });
}

// The warp's 16 output rows of a step: out[i0 + r] = sum_j Band[r, j]
// window[c0 + j] for window chunk rows c0 = 64 k + 16 w on; one n-tile pair
// (16 features) at a time, rounded to T and staged in the warp's [16, 16]
// tile, so that each lane stores 16 bytes and a row's 32 bytes (a whole
// sector; 64 in float32) go out whole (stored from the fragments, a 16-byte
// piece of 8 rows an instruction, the conv ran at half the HBM rate); rows
// past n and the pad columns are skipped. out points at the part's first
// column of a [n, d] matrix.
template <int WT, typename T>
__device__ __forceinline__ void band_step(const AFrag<T> (&a)[WT], const T* ring, int ld,
                                          int c0, T* stage, T* out, int i0, int n, int cols,
                                          int d, bool vec) {
  constexpr int V = vec16<T>(), P = 16 / V;  // 16-byte pieces a staged row
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int np = 0; np < (cols + 15) / 16; ++np) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < WT; ++kk) {
      const AOp<T> fa = attn::prepare(a[kk]);
      BFrag<T> fb[2];
      attn::load_b_kn<T>(fb, [&](int r) { return ring + ring_row(c0 + 16 * kk + r) * ld + 16 * np; });
      attn::mma_step(acc[0], fa, fb[0]);
      attn::mma_step(acc[1], fa, fb[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      store2(stage + g * 16 + 8 * h + 2 * t, acc[h][0], acc[h][1]);
      store2(stage + (g + 8) * 16 + 8 * h + 2 * t, acc[h][2], acc[h][3]);
    }
    __syncwarp();
    if (vec) {
#pragma unroll
      for (int idx = lane; idx < 16 * P; idx += 32) {
        const int srow = idx / P, piece = idx % P;
        const int col = 16 * np + V * piece;
        if (i0 + srow < n && col < cols)
          *reinterpret_cast<uint4*>(out + (size_t)(i0 + srow) * d + col) =
              *reinterpret_cast<const uint4*>(stage + srow * 16 + V * piece);
      }
    } else {  // rows not 16-byte aligned: element by element
      for (int idx = lane; idx < 16 * 16; idx += 32) {
        const int srow = idx / 16, col = 16 * np + idx % 16;
        if (i0 + srow < n && col < cols)
          out[(size_t)(i0 + srow) * d + col] = stage[srow * 16 + idx % 16];
      }
    }
    __syncwarp();
  }
}

// The conv of one ring: out = conv(src, taps), the forward (kern as it is)
// and dv alone (src = g, the taps flipped), over one chunk and one feature
// part of at most kMaxDim columns (the grid's z; one part up to d 128).
template <int WT, typename T>
__global__ void __launch_bounds__(kThreads)
    conv1d_kernel(const T* __restrict__ src, const T* __restrict__ kern, T* __restrict__ out,
                  int heads, int n, int d, int ksize, int flip, int steps_per_chunk,
                  int pcols) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = fwd_row(pcols);
  const int f0 = blockIdx.z * pcols, cols = min(pcols, d - f0);
  const bool vec = d % vec16<T>() == 0;
  T* sTap = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + head_bytes<T>());
  const int bh = blockIdx.y, warp = threadIdx.x / 32;
  T* stage = reinterpret_cast<T*>(smem + tap_bytes<T>()) + warp * 16 * 16;
  const int steps = (n + kStep - 1) / kStep, s0 = blockIdx.x * steps_per_chunk;
  const int ns = min(steps_per_chunk, steps - s0), row0 = s0 * kStep - ksize / 2;
  const int last_rows = 16 * WT - 16;  // the last stage: the halo of step ns - 1
  const size_t base = (size_t)bh * n * d + f0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st <= ns)
      load_stage(ring, ld, src + base, row0, st, st < ns ? kStep : last_rows, n, cols, d);
    cp_async_commit();
  }
  if (vec) zero_pad(ring, ld, cols);  // (the element loads write the pad's zeros)
  for (int t = threadIdx.x; t < ksize; t += kThreads)
    sTap[t] = kern[(bh % heads) * ksize + (flip ? ksize - 1 - t : t)];
  __syncthreads();
  AFrag<T> a[WT];
  band_frags<WT>(a, sTap, ksize);
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<kStages - 3>();
    __syncthreads();
    const int st = k + kStages - 1;
    if (st <= ns)
      load_stage(ring, ld, src + base, row0, st, st < ns ? kStep : last_rows, n, cols, d);
    cp_async_commit();
    band_step<WT>(a, ring, ld, kStep * k + 16 * warp, stage, out + base,
                  (s0 + k) * kStep + 16 * warp, n, cols, d, vec);
  }
}

// dv (the band product on g with the flipped taps, as conv1d_kernel) and
// the block's dkern partial (the Toeplitz product of g and v), over one
// chunk and one feature part (the grid's z, of pcols columns a part):
// partial[((b chunks + chunk) parts + part) h K + h K + t].
template <int WT, typename T>
__global__ void __launch_bounds__(kThreads)
    conv1d_bwd_kernel(const T* __restrict__ v, const T* __restrict__ kern,
                      const T* __restrict__ g, T* __restrict__ dv,
                      float* __restrict__ partial, int heads, int n, int d, int ksize,
                      int steps_per_chunk, int pcols) {
  constexpr int NT = 2 * WT;  // n8 tiles of s
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = pcols + 8, half = ksize / 2;
  const int f0 = blockIdx.z * pcols, cols = min(pcols, d - f0);
  T* sTap = reinterpret_cast<T*>(smem);
  T* gring = reinterpret_cast<T*>(smem + head_bytes<T>());
  T* vring = reinterpret_cast<T*>(smem + head_bytes<T>() + ring_bytes<T>(pcols));
  const int bh = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* stage = reinterpret_cast<T*>(smem + tap_bytes<T>()) + warp * 16 * 16;
  const int steps = (n + kStep - 1) / kStep, s0 = blockIdx.x * steps_per_chunk;
  const int ns = min(steps_per_chunk, steps - s0), row0 = s0 * kStep - half;
  const int last_rows = 16 * WT - 16;
  const size_t base = (size_t)bh * n * d + f0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st <= ns) {
      const int rows = st < ns ? kStep : last_rows;
      load_stage(gring, ld, g + base, row0, st, rows, n, cols, d);
      load_stage(vring, ld, v + base, row0, st, rows, n, cols, d);
    }
    cp_async_commit();
  }
  zero_pad(gring, ld, cols);
  zero_pad(vring, ld, cols);
  for (int t = threadIdx.x; t < ksize; t += kThreads)
    sTap[t] = kern[(bh % heads) * ksize + ksize - 1 - t];
  __syncthreads();
  AFrag<T> a[WT];
  band_frags<WT>(a, sTap, ksize);

  float csum[NT][4] = {};
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<kStages - 3>();
    __syncthreads();
    const int st = k + kStages - 1;
    if (st <= ns) {
      const int rows = st < ns ? kStep : last_rows;
      load_stage(gring, ld, g + base, row0, st, rows, n, cols, d);
      load_stage(vring, ld, v + base, row0, st, rows, n, cols, d);
    }
    cp_async_commit();
    const int c0 = kStep * k + 16 * warp;
    band_step<WT>(a, gring, ld, c0, stage, dv + base, (s0 + k) * kStep + 16 * warp, n, cols,
                  d, true);

    // C[r, s] += g[c0 + half + r] . v[c0 + s] over the part's features
    float c[NT][4] = {};
    for (int f = 0; f < (cols + 15) / 16; ++f) {
      const AOp<T> fa = attn::prepare(attn::load_a<T>(
          [&](int r) { return gring + ring_row(c0 + half + r) * ld + 16 * f; }));
#pragma unroll
      for (int sp = 0; sp < WT; ++sp) {
        BFrag<T> fb[2];
        attn::load_b_nk<T>(fb, [&](int s) { return vring + ring_row(c0 + 16 * sp + s) * ld + 16 * f; });
        attn::mma_step(c[2 * sp], fa, fb[0]);
        attn::mma_step(c[2 * sp + 1], fa, fb[1]);
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
  float* out = partial +
      ((((size_t)b * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z) * heads + h) * ksize;
  for (int t = threadIdx.x; t < ksize; t += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w)
      for (int r = 0; r < 16; ++r) sum += sC[(w * 16 + r) * 16 * WT + r + t];
    out[t] = sum;
  }
}

// The forward (and dv alone) take any d; the backward d a multiple of 8 up
// to kMaxDim.
bool valid_fwd(int bh, int heads, int n, int d, int ksize) {
  return bh > 0 && heads > 0 && bh % heads == 0 && n > 0 && d > 0 && ksize > 0 &&
         ksize % 2 == 1 && ksize <= kMaxTaps;
}

bool valid_bwd(int bh, int heads, int n, int d, int ksize) {
  return valid_fwd(bh, heads, n, d, ksize) && d % 8 == 0 && d <= kMaxDim;
}

template <int WT, typename T>
cudaError_t launch_conv(const T* src, const T* kern, T* out, int bh, int heads, int n, int d,
                        int ksize, bool flip, cudaStream_t stream) {
  const int pcols = d < kMaxDim ? d : kMaxDim, parts = (d + pcols - 1) / pcols;
  const size_t smem = smem_bytes<T>(fwd_row(pcols) - 8, false, WT);
  cudaError_t err = allow_smem(conv1d_kernel<WT, T>, smem);
  if (err != cudaSuccess) return err;
  const Plan p = conv_plan(bh, n);
  conv1d_kernel<WT, T><<<dim3(p.chunks, bh, parts), kThreads, smem, stream>>>(
      src, kern, out, heads, n, d, ksize, flip ? 1 : 0, p.steps_per_chunk, pcols);
  return cudaGetLastError();
}

template <int WT, typename T>
cudaError_t launch_conv_bwd(const T* v, const T* kern, const T* g, T* dv, float* partial,
                            int bh, int heads, int n, int d, int ksize, cudaStream_t stream) {
  const Parts f = feature_parts<T>(d, WT);
  const size_t smem = smem_bytes<T>(f.cols, true, WT);
  cudaError_t err = allow_smem(conv1d_bwd_kernel<WT, T>, smem);
  if (err != cudaSuccess) return err;
  const Plan p = conv_plan(bh, n);
  conv1d_bwd_kernel<WT, T><<<dim3(p.chunks, bh, f.parts), kThreads, smem, stream>>>(
      v, kern, g, dv, partial, heads, n, d, ksize, p.steps_per_chunk, f.cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t conv(const T* src, const T* kern, T* out, int bh, int heads, int n, int d,
                 int ksize, bool flip, cudaStream_t stream) {
  if (!valid_fwd(bh, heads, n, d, ksize)) return cudaErrorInvalidValue;
  cudaError_t (*launch)(const T*, const T*, T*, int, int, int, int, int, bool, cudaStream_t);
  switch (band_tiles(ksize)) {
    case 1: launch = launch_conv<1, T>; break;
    case 2: launch = launch_conv<2, T>; break;
    case 3: launch = launch_conv<3, T>; break;
    case 4: launch = launch_conv<4, T>; break;
    default: launch = launch_conv<5, T>;
  }
  return launch(src, kern, out, bh, heads, n, d, ksize, flip, stream);
}

template <typename T>
int feature_parts_of(int d, int ksize) {
  return feature_parts<T>(d, band_tiles(ksize)).parts;
}

}  // namespace

long long conv1d_bwd_partial_elems(int bh, int n, int d, int ksize, int dtype) {
  int parts = 1;
  by_type(dtype, [&](auto e) {
    parts = feature_parts_of<decltype(e)>(d, ksize);
    return cudaSuccess;
  });
  return (long long)bh * conv_plan(bh, n).chunks * parts * ksize;
}

template <typename T>
cudaError_t conv1d_bwd(const T* v, const T* kern, const T* g, T* dv, float* dkern,
                       float* partial, int bh, int heads, int n, int d, int ksize,
                       cudaStream_t stream) {
  if (!valid_bwd(bh, heads, n, d, ksize)) return cudaErrorInvalidValue;
  cudaError_t (*launch)(const T*, const T*, const T*, T*, float*, int, int, int, int, int,
                        cudaStream_t);
  switch (band_tiles(ksize)) {
    case 1: launch = launch_conv_bwd<1, T>; break;
    case 2: launch = launch_conv_bwd<2, T>; break;
    case 3: launch = launch_conv_bwd<3, T>; break;
    case 4: launch = launch_conv_bwd<4, T>; break;
    default: launch = launch_conv_bwd<5, T>;
  }
  cudaError_t err = launch(v, kern, g, dv, partial, bh, heads, n, d, ksize, stream);
  if (err != cudaSuccess) return err;
  // dkern[h, t] = the column sum of the partials over batch, chunks and parts
  return launch_column_sum(partial,
                           bh / heads * conv_plan(bh, n).chunks * feature_parts_of<T>(d, ksize),
                           (long long)heads * ksize, dkern, stream);
}

template cudaError_t conv1d_bwd<bf16>(const bf16*, const bf16*, const bf16*, bf16*, float*,
                                      float*, int, int, int, int, int, cudaStream_t);
template cudaError_t conv1d_bwd<f16>(const f16*, const f16*, const f16*, f16*, float*, float*,
                                     int, int, int, int, int, cudaStream_t);
template cudaError_t conv1d_bwd<float>(const float*, const float*, const float*, float*,
                                       float*, float*, int, int, int, int, int, cudaStream_t);

// Elements of the fp32 `partial` scratch that mirror_conv1d_bwd and the
// conv of mirror_softmax_attn_bwd need.
MIRROR_EXPORT long long mirror_conv1d_bwd_partial_elems(int bh, int n, int d, int ksize,
                                                        int dtype) {
  return conv1d_bwd_partial_elems(bh, n, d, ksize, dtype);
}

// v, out: [bh, n, d]; kern: [heads, ksize], all of type code dtype
// (common.cuh's Elem); any d >= 1 (parts of at most 128 features a block
// above 128), ksize odd up to 65.
MIRROR_EXPORT int mirror_conv1d(const void* v, const void* kern, void* out, int bh, int heads,
                                int n, int d, int ksize, int dtype, cudaStream_t stream) {
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    return conv(static_cast<const T*>(v), static_cast<const T*>(kern), static_cast<T*>(out), bh,
                heads, n, d, ksize, false, stream);
  });
}

// g, dv: [bh, n, d] and kern [heads, ksize] of type code dtype; dkern: fp32
// [heads, ksize]; partial: fp32 scratch of mirror_conv1d_bwd_partial_elems(bh,
// n, d, ksize, dtype) elements.
MIRROR_EXPORT int mirror_conv1d_bwd(const void* v, const void* kern, const void* g, void* dv,
                                    void* dkern, void* partial, int bh, int heads, int n, int d,
                                    int ksize, int dtype, cudaStream_t stream) {
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    return conv1d_bwd(static_cast<const T*>(v), static_cast<const T*>(kern),
                      static_cast<const T*>(g), static_cast<T*>(dv), static_cast<float*>(dkern),
                      static_cast<float*>(partial), bh, heads, n, d, ksize, stream);
  });
}

// dv alone (the backward's first half, no dkern): g, dv [bh, n, d] and kern
// [heads, ksize] of type code dtype.
MIRROR_EXPORT int mirror_conv1d_bwd_dv(const void* kern, const void* g, void* dv, int bh,
                                       int heads, int n, int d, int ksize, int dtype,
                                       cudaStream_t stream) {
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    return conv(static_cast<const T*>(g), static_cast<const T*>(kern), static_cast<T*>(dv), bh,
                heads, n, d, ksize, true, stream);
  });
}

// out[j] = sum over p < nparts of parts[p * count + j], fp32, in
// launch_column_sum's fixed order: the backward's second pass (dkern from
// its partials), launched alone so the probe can time it.
MIRROR_EXPORT int mirror_column_sum(const void* parts, int nparts, long long count, void* out,
                                    cudaStream_t stream) {
  return (int)launch_column_sum(static_cast<const float*>(parts), nparts, count,
                                static_cast<float*>(out), stream);
}
