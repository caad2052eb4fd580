// Landmark means and landmark softmax of the Nystrom attention (K1); its
// backward (K1b) is landmark_bwd.cu, which this comment describes too.
//
// Replaces: mirror_tpu/ops/landmark_pallas.py::landmark_softmax, the
// forward pallas_call in _fwd_call (body _fwd_kernel) and (landmark_bwd.cu)
// the backward pallas_call in _bwd_call (body _bwd_kernel).
//
// What it computes, per (batch, head):
// - forward: q_l, k_l = means over contiguous groups of l rows of the
//   virtually FRONT-PADDED sequence (real row i lies in group (i + pad) / l,
//   the divisor is always l, groups made only of pad rows are exactly 0),
//   summed in fp32 and rounded to bf16 once; attn2 = softmax(q_l k_l^T) with
//   fp32 similarity and statistics, rounded to bf16; and, for the backward,
//   lse = the fp32 row log-sum-exp of q_l k_l^T.
// - backward, with the TPU kernel's rounding points and P = exp(S - lse):
//   dsim = bf16(P ga2 - P rowsum(P ga2)); dq_l = dsim k_l + gql and
//   dk_l = dsim^T q_l + gkl in fp32, times 1/l and rounded once; real row i
//   takes its group's value, and groups made only of pad send gradient
//   nowhere.
//
// What bounds it on the H100: bytes. At the slice's shape (b 16, h 8,
// n 2117, pad 187, dh 96, m 384) q and k are 52.0 MB each; the forward reads
// them once and writes q_l, k_l (9.4 MB each) and attn2 (37.7 MB): 160.7 MB,
// 0.048 ms at 3.35 TB/s (lse adds 0.2 MB), against 3.6 GFLOP for S (0.004
// ms at the bf16 peak). The backward reads q_l, k_l, lse, gql, gkl and ga2 and
// writes dq and dk: 179.7 MB, 0.054 ms (the TPU kernel's residuals, q and k
// with the means recomputed, would make it 264.7 MB), against 5 products of
// 2 m m dh a (batch, head) run by this design (S twice in the row pass,
// once transposed in the column pass, dsim k_l, dsim^T q_l): 18 GFLOP.
//
// Design. The TPU program keeps one (batch, head)'s q and k rows, the
// means and the whole [m, m] softmax in VMEM; a Hopper block cannot hold
// that, and one block a (batch, head) would leave most SMs idle. So:
// (1) means: a streaming reduction. A thread owns 8 features (one 16-byte
//     load) of one group and walks the group's l contiguous rows of q and
//     of k, two rows of each in flight; stores are 16 bytes. No thread idles
//     at dh 64 or 96, and every real row is read once.
// (2) forward rows: a block of 4 warps owns 64 rows of q_l, 16 a warp; each
//     warp loads its A fragments once (ldmatrix) and keeps them in
//     registers. k_l arrives in 64-row tiles through a 2-stage cp.async ring
//     (attn_mma.cuh), and the walk runs twice: sweep 1 forms S in registers
//     (mma.sync m16n8k16, fp32 accumulators) and keeps the online row max
//     and sum (two quad shuffles a row); sweep 2 forms S again (cheap: the
//     function is bound by bytes) and writes P = exp2(S log2e - lse log2e)
//     as bf16, staged through a small per-warp tile so that every store to
//     attn2 is 16 bytes and coalesced (element by element when a row of
//     attn2 is not whole 16-byte pieces: m % 8 != 0 in the 16-bit types).
//     No [64, m] block is kept in shared memory, so any m is taken (the
//     earlier design staged the fp32 scores and took m <= 768 only). The
//     second walk re-reads k_l (72 KB a (batch, head)) from L2.
// (2') dh above 128: the same two sweeps with S summed over 128-column
//     chunks of dh that stream through the ring with their q_l rows
//     (landmark_fwd_wide_kernel). A dh that is not a multiple of 16 takes
//     the ceil(dh / 16) instance with its last k step zero-filled, and rows
//     that are not whole 16-byte pieces (dh % 8 != 0 in the 16-bit types)
//     load element by element (attn_mma.cuh::load_cols), as the means do
//     (landmark_means_any_kernel).
// (3) backward (landmark_bwd.cu), FlashAttention-2's split, with no
//     [m, m] scratch and no float atomics:
//     rows: a block owns 64 rows i of one (batch, head), A = q_l in
//       registers. It walks the column tiles j twice through a ring of k_l
//       and ga2 tiles: sweep 1 reduces dot_i = sum_j P_ij ga2_ij, sweep 2
//       forms dsim in registers; rounded to bf16 in place it is the A
//       operand of dq += dsim k_l (k_l read by ldmatrix.trans). It writes dot
//       (fp32 [bh, m]) for the column pass.
//     cols: a block owns 64 landmark columns j, A = k_l in registers, and
//       walks the row tiles i of q_l with their lse and dot: S^T = k_l q_l^T
//       in registers, P^T from lse_i, ga2^T read from the staged [i, j] tile
//       by ldmatrix.trans straight into the accumulator's layout, dsim^T as
//       the A operand of dk += dsim^T q_l.
//     One epilogue: add gql or gkl, times 1/l, round, stage the [64, dh]
//     bf16 result in shared memory, then write the block's groups' real rows
//     (a contiguous span of dq or dk) with 16-byte coalesced stores.
//     One block owns each output tile and sums in a fixed order, so two runs
//     give the same bits. The row and column passes compute P from S and
//     from S^T, whose products the tensor cores may add in another order,
//     so a P can differ by an ulp between them; the plain emulation in
//     tests/test_torch_port_landmark_design.py holds both orders to the
//     reference.
// Occupancy (dh 96; ptxas -v, printed by chip_smoke.py), no spills: the
// means 48 registers a thread, 256 threads a block; the forward rows 114
// registers and 39.9 KB of shared memory, 4 blocks (16 warps) an SM; the
// row and column passes 185 and 176 registers and 72.7 KB, 2 blocks an SM.
// Element types (attn_mma.cuh): q, k and every output but lse are of the
// compute type T, bf16 in the sentences above, float16 or float32; the
// means, S, the statistics and the products' sums are fp32, rounded to T
// where bf16 is (the means, attn2, dsim, dq and dk; float32's are the
// identity). float32's products are 3xTF32, a thread's means load 4
// features, and its tiles double: the forward's 80 KB (dh 96) leave room
// for 2 blocks an SM, the backward's 144 KB for one.
#include "landmark.cuh"

namespace {

using namespace attn;
using namespace landmark;

// (1) the means, a thread per (batch * head, group, 16 bytes of features:
// 8 of a 16-bit type, 4 of float32)
constexpr int kMeanThreads = 256;

template <typename T>
__device__ __forceinline__ void add16(float (&s)[vec16<T>()], const uint4& v) {
  const T* p = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int e = 0; e < vec16<T>() / 2; ++e) {
    const float2 f = load2(p + 2 * e);
    s[2 * e] += f.x;
    s[2 * e + 1] += f.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&s)[vec16<T>()], float scale) {
  uint4 v;
  T* p = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int e = 0; e < vec16<T>() / 2; ++e) store2(p + 2 * e, s[2 * e] * scale, s[2 * e + 1] * scale);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMeanThreads)
    landmark_means_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          T* __restrict__ q_l, T* __restrict__ k_l, int bh, int n,
                          int dh, int m, int l, int pad) {
  constexpr int V = vec16<T>();
  const int chunks = dh / V;
  const long long idx = (long long)blockIdx.x * kMeanThreads + threadIdx.x;
  if (idx >= (long long)bh * m * chunks) return;
  const int c = (int)(idx % chunks);
  const long long grp = idx / chunks;  // bh * m + group
  const int g = (int)(grp % m);
  const size_t base = (size_t)(grp / m) * n * dh + (size_t)c * V;
  const uint4* qp = reinterpret_cast<const uint4*>(q + base);
  const uint4* kp = reinterpret_cast<const uint4*>(k + base);
  const int stride = chunks;  // uint4s a row
  float sq[V] = {}, sk[V] = {};
  const int first = g * l - pad;  // rows before 0 are the pad's zeros
  int r = max(first, 0);
  const int end = min(first + l, n);
  for (; r + 1 < end; r += 2) {
    const uint4 q0 = qp[(size_t)r * stride], q1 = qp[(size_t)(r + 1) * stride];
    const uint4 k0 = kp[(size_t)r * stride], k1 = kp[(size_t)(r + 1) * stride];
    add16<T>(sq, q0);
    add16<T>(sq, q1);
    add16<T>(sk, k0);
    add16<T>(sk, k1);
  }
  if (r < end) {
    add16<T>(sq, qp[(size_t)r * stride]);
    add16<T>(sk, kp[(size_t)r * stride]);
  }
  const float inv_l = 1.0f / (float)l;
  const size_t out = (size_t)grp * dh + (size_t)c * V;
  *reinterpret_cast<uint4*>(q_l + out) = pack16<T>(sq, inv_l);
  *reinterpret_cast<uint4*>(k_l + out) = pack16<T>(sk, inv_l);
}

// (1) for a dh that is not a whole number of 16-byte pieces (a row is then
// not 16-byte aligned): the same walk, a thread's features read and written
// one element at a time, the last thread of a row owning dh % V of them.
// The sums run in the same row order.
template <typename T>
__global__ void __launch_bounds__(kMeanThreads)
    landmark_means_any_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              T* __restrict__ q_l, T* __restrict__ k_l, int bh, int n, int dh,
                              int m, int l, int pad) {
  constexpr int V = vec16<T>();
  const int chunks = (dh + V - 1) / V;
  const long long idx = (long long)blockIdx.x * kMeanThreads + threadIdx.x;
  if (idx >= (long long)bh * m * chunks) return;
  const int f0 = (int)(idx % chunks) * V, nf = min(V, dh - f0);
  const long long grp = idx / chunks;  // bh * m + group
  const int g = (int)(grp % m);
  const T* qp = q + (size_t)(grp / m) * n * dh + f0;
  const T* kp = k + (size_t)(grp / m) * n * dh + f0;
  float sq[V] = {}, sk[V] = {};
  const int first = g * l - pad;
  for (int r = max(first, 0); r < min(first + l, n); ++r) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < nf) {
        sq[e] += Elem<T>::to_float(qp[(size_t)r * dh + e]);
        sk[e] += Elem<T>::to_float(kp[(size_t)r * dh + e]);
      }
    }
  }
  const float inv_l = 1.0f / (float)l;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (e < nf) {
      q_l[(size_t)grp * dh + f0 + e] = Elem<T>::from_float(sq[e] * inv_l);
      k_l[(size_t)grp * dh + f0 + e] = Elem<T>::from_float(sk[e] * inv_l);
    }
  }
}

// The ragged edge of a 64-column tile at c0: the logits of columns at or
// past m (zero-filled k_l rows) masked to -inf.
__device__ __forceinline__ void mask_edge(float (&s)[8][4], int c0, int m) {
  const int t = threadIdx.x % 4;
  if (c0 + BN > m) {
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + 8 * nn + 2 * t + (e & 1) >= m) s[nn][e] = -INFINITY;
  }
}

// Sweep 1 on one tile of S at c0, for the warp's rows g and g + 8: the
// online max and sum in the exp2 form; after the last tile, the row lse
// (written to lse[row_lo], lse[row_lo + 8] by the quad's first lane) and
// its log2(e)-scaled ml2 for sweep 2.
__device__ __forceinline__ void sweep1_step(float (&s)[8][4], float (&mx)[2], float (&sum)[2],
                                            float (&ml2)[2], int c0, int m, bool last,
                                            float* lse, int row_lo) {
  mask_edge(s, c0, m);
  float tmx[2] = {mx[0], mx[1]};
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) {
    tmx[0] = fmaxf(tmx[0], fmaxf(s[nn][0], s[nn][1]));
    tmx[1] = fmaxf(tmx[1], fmaxf(s[nn][2], s[nn][3]));
  }
  float part[2] = {0.f, 0.f}, mneg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tmx[i] = fmaxf(tmx[i], __shfl_xor_sync(0xffffffffu, tmx[i], 1));
    tmx[i] = fmaxf(tmx[i], __shfl_xor_sync(0xffffffffu, tmx[i], 2));
    sum[i] *= fast_exp2((mx[i] - tmx[i]) * kLog2e);  // 0 while mx is -inf
    mx[i] = tmx[i];
    mneg[i] = -tmx[i] * kLog2e;
  }
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[e / 2] += fast_exp2(fmaf(s[nn][e], kLog2e, mneg[e / 2]));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
    sum[i] += part[i];
  }
  if (last) {
    const float lse_lo = mx[0] + logf(sum[0]), lse_hi = mx[1] + logf(sum[1]);
    ml2[0] = lse_lo * kLog2e;
    ml2[1] = lse_hi * kLog2e;
    if (threadIdx.x % 4 == 0) {
      if (row_lo < m) lse[row_lo] = lse_lo;
      if (row_lo + 8 < m) lse[row_lo + 8] = lse_hi;
    }
  }
}

// Sweep 2 on one tile of S at c0: P = exp2(S log2e - lse log2e) in place.
__device__ __forceinline__ void sweep2_probs(float (&s)[8][4], const float (&ml2)[2], int c0,
                                             int m) {
  mask_edge(s, c0, m);
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nn][e] = fast_exp2(fmaf(s[nn][e], kLog2e, -ml2[e / 2]));
}

// (2) forward rows. Shared memory: the q_l tile (its space then stages P,
// stride LDP), then the ring of kStages k_l tiles (tile t + kStages - 1 is
// in flight while tile t is multiplied).

template <int DT>
__host__ __device__ constexpr int q_stride() {
  return row_stride<DT>() > LDP ? row_stride<DT>() : LDP;
}

template <typename T, int DT>
__host__ __device__ constexpr size_t fwd_smem() {
  return ((size_t)BM * q_stride<DT>() + (size_t)kStages * BN * row_stride<DT>()) * sizeof(T);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 4)
    landmark_fwd_kernel(const T* __restrict__ q_l, const T* __restrict__ k_l,
                        T* __restrict__ attn2, float* __restrict__ lse, int m, int dh) {
  constexpr int DH = 16 * DT, LD = row_stride<DT>();  // dh <= DH
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sRing = sQ + BM * q_stride<DT>();

  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
  const T* kb = k_l + (size_t)bh * m * dh;
  const int ntiles = (m + BN - 1) / BN, nsteps = 2 * ntiles;  // two sweeps
  auto issue = [&](int step) {  // k_l tile step % ntiles into ring stage step % kStages
    if (step < nsteps)
      load_cols<DH>(sRing + (step % kStages) * BN * LD, LD, kb, dh, 0, (step % ntiles) * BN,
                    BN, m);
    cp_async_commit();
  };
  load_cols<DH>(sQ, LD, q_l + (size_t)bh * m * dh, dh, 0, r0, BM, m);
  for (int step = 0; step < kStages - 1; ++step) issue(step);  // the q_l tile joins group 0

  AFrag<T> aq[DT];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, ml2[2] = {0.f, 0.f};
  T* stage = sQ + warp * 16 * LDP;  // free once every warp holds its A fragments
  const int row_lo = r0 + warp * 16 + g;
  for (int it = 0; it < nsteps; ++it) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();  // tile it (and at it 0 the q_l tile) has landed
    __syncthreads();
    if (it == 0) load_a_frags<DT>(aq, sQ + warp * 16 * LD, LD);

    const int c0 = (it % ntiles) * BN;
    float s[8][4];
    zero(s);
    mma_nt_ra<DT, 8>(s, aq, sRing + (it % kStages) * BN * LD, LD);
    if (it < ntiles) {  // sweep 1
      sweep1_step(s, mx, sum, ml2, c0, m, it == ntiles - 1, lse + (size_t)bh * m, row_lo);
      continue;
    }
    // sweep 2: P in T, staged, then the warp's 16 rows stored
    sweep2_probs(s, ml2, c0, m);
    stage_rows<8>(stage, LDP, s, 1.f, 1.f);
    store_cols<BN>(attn2 + (size_t)bh * m * m, stage, LDP, r0 + warp * 16, m, m, c0);
  }
}

// (2') forward rows at dh above 128: the rows kernel above with S = q_l
// k_l^T summed over chunks of WD columns of dh. Each ring step holds a
// q_l chunk and a k_l chunk (the A fragments no longer stay in registers:
// q_l is streamed again a column tile, from L2); both sweeps walk the same
// steps, and sweep 2 stages P in the warp's own 16 rows of the q_l chunk it
// has just multiplied.
constexpr int WD = 128;                 // columns of a dh chunk
constexpr int WLD = WD + 8;             // their row stride
constexpr int WSTAGE = (BM + BN) * WLD;  // a stage: a q_l and a k_l chunk

template <typename T>
__host__ __device__ constexpr size_t wide_smem() {
  return (size_t)kStages * WSTAGE * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 1 : 2)
    landmark_fwd_wide_kernel(const T* __restrict__ q_l, const T* __restrict__ k_l,
                             T* __restrict__ attn2, float* __restrict__ lse, int m, int dh) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sRing = reinterpret_cast<T*>(smem);
  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
  const T* qb = q_l + (size_t)bh * m * dh;
  const T* kb = k_l + (size_t)bh * m * dh;
  const int chunks = (dh + WD - 1) / WD, ntiles = (m + BN - 1) / BN;
  const int sweep = ntiles * chunks, nsteps = 2 * sweep;
  auto issue = [&](int st) {  // step st into ring stage st % kStages
    if (st < nsteps) {
      T* dst = sRing + (st % kStages) * WSTAGE;
      const int u = st % chunks, tile = (st % sweep) / chunks;
      load_cols<WD>(dst, WLD, qb, dh, u * WD, r0, BM, m);
      load_cols<WD>(dst + BM * WLD, WLD, kb, dh, u * WD, tile * BN, BN, m);
    }
    cp_async_commit();
  };
  issue(0);
  float s[8][4];
  zero(s);
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, ml2[2] = {0.f, 0.f};
  const int row_lo = r0 + warp * 16 + g;
  for (int st = 0; st < nsteps; ++st) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    issue(st + 1);
    cp_async_wait<1>();  // step st has landed
    __syncthreads();
    T* sA = sRing + (st % kStages) * WSTAGE;
    const int u = st % chunks, tile = (st % sweep) / chunks, c0 = tile * BN;
    if (u == 0) zero(s);
    mma_nt_kt<WD / 16, 8>(s, sA + warp * 16 * WLD, sA + BM * WLD, WLD,
                          (min(WD, dh - u * WD) + 15) / 16);
    if (u + 1 < chunks) continue;
    if (st < sweep) {  // sweep 1
      sweep1_step(s, mx, sum, ml2, c0, m, tile == ntiles - 1, lse + (size_t)bh * m, row_lo);
      continue;
    }
    // sweep 2: P in T, staged in this warp's q_l rows of the stage
    sweep2_probs(s, ml2, c0, m);
    T* stage = sA + warp * 16 * WLD;
    __syncwarp();  // every lane of the warp is done reading its A rows
    stage_rows<8>(stage, WLD, s, 1.f, 1.f);
    store_cols<BN>(attn2 + (size_t)bh * m * m, stage, WLD, r0 + warp * 16, m, m, c0);
  }
}

// DT 0: dh above 128, the wide kernel
template <typename T, int DT>
cudaError_t launch_fwd(const T* q_l, const T* k_l, T* attn2, float* lse, int bh, int m,
                       int dh, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, bh);
  if constexpr (DT == 0) {
    const cudaError_t err = allow_smem(landmark_fwd_wide_kernel<T>, wide_smem<T>());
    if (err != cudaSuccess) return err;
    landmark_fwd_wide_kernel<T><<<grid, kThreads, wide_smem<T>(), stream>>>(q_l, k_l, attn2,
                                                                           lse, m, dh);
  } else {
    const size_t smem = fwd_smem<T, DT>();
    const cudaError_t err = allow_smem(landmark_fwd_kernel<T, DT>, smem);
    if (err != cudaSuccess) return err;
    landmark_fwd_kernel<T, DT><<<grid, kThreads, smem, stream>>>(q_l, k_l, attn2, lse, m, dh);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const T* q, const T* k, T* q_l, T* k_l, T* attn2, float* lse, int bh,
                       int n, int dh, int m, int l, int pad, cudaStream_t stream) {
  // by ceil(dh / 16): the DT instance (a ragged dh zero-fills its last k
  // step); index 8, any dh above 128
  using FwdFn = cudaError_t (*)(const T*, const T*, T*, float*, int, int, int, cudaStream_t);
  constexpr FwdFn kFwd[9] = {launch_fwd<T, 1>, launch_fwd<T, 2>, launch_fwd<T, 3>,
                             launch_fwd<T, 4>, launch_fwd<T, 5>, launch_fwd<T, 6>,
                             launch_fwd<T, 7>, launch_fwd<T, 8>, launch_fwd<T, 0>};
  constexpr int V = vec16<T>();
  const long long threads = (long long)bh * m * ((dh + V - 1) / V);
  const unsigned blocks = (unsigned)((threads + kMeanThreads - 1) / kMeanThreads);
  if (dh % V == 0)
    landmark_means_kernel<T><<<blocks, kMeanThreads, 0, stream>>>(q, k, q_l, k_l, bh, n, dh, m,
                                                                 l, pad);
  else
    landmark_means_any_kernel<T><<<blocks, kMeanThreads, 0, stream>>>(q, k, q_l, k_l, bh, n,
                                                                     dh, m, l, pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return kFwd[dh > 128 ? 8 : (dh + 15) / 16 - 1](q_l, k_l, attn2, lse, bh, m, dh, stream);
}
}  // namespace

// q, k: [bh, n, dh]; q_l, k_l: [bh, m, dh]; attn2: [bh, m, m], all of type
// code dtype (common.cuh's Elem); lse: fp32 [bh, m], the row log-sum-exp
// the backward takes.
MIRROR_EXPORT int mirror_landmark_softmax(const void* q, const void* k, void* q_l, void* k_l,
                                          void* attn2, void* lse, int bh, int n, int dh, int m,
                                          int l, int pad, int dtype, cudaStream_t stream) {
  if (!landmark::fwd_shape_ok(n, dh, m, l, pad)) return (int)cudaErrorInvalidValue;
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    return launch_all<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<T*>(q_l), static_cast<T*>(k_l), static_cast<T*>(attn2),
                         static_cast<float*>(lse), bh, n, dh, m, l, pad, stream);
  });
}
