// Multi-head attention on the natural [b, n, d] layout of the ViT (K8, and
// the middle launch of K6).
//
// Replaces: mirror_tpu/ops/vit_attn_pallas.py::mha_natural (the pallas_call
// of _mha_natural, kernel body _kernel) and the per-head attention inside
// ::_attn_block_kernel.
//
// What it computes, per image and head h: out[:, h dh:(h+1) dh] =
// bf16(bf16(softmax(q_h k_h^T * dh^-0.5)) v_h), where q_h is columns
// [h dh, (h+1) dh) of q's rows (row stride ld_in: d for separate q, k, v, 3d
// for the fused q|k|v buffer of attn_block). The scores, the softmax
// statistics and both products' sums are fp32; the normalised probabilities
// are rounded to bf16 before P v, and each head's output once, at the TPU
// kernel's rounding points. Columns past n weigh 0: unlike the Nystrom
// kernels' pad, they are not part of the softmax.
//
// What bounds it on the H100: device-memory bytes. At Phikon's batch of 256
// (n 197, 12 heads, dh 64) q, k, v and out are 4 x 77.5 MB (0.093 ms at
// 3.35 TB/s) against 3.0e10 FLOP of products (0.031 ms at 989 TFLOP/s).
//
// Design (on attn_mma.cuh's mma.sync m16n8k16 and ldmatrix):
// - One block owns a whole (image, head) pair: K_h and V_h (n rounded up to
//   16 rows, zero-filled, row stride dh + 8) go to shared memory once a
//   pair with cp.async, and the block's warps walk all of the pair's 16-row
//   query tiles (13 at n 197). Each element of q, k and v crosses device
//   memory once and out is written once: the bytes bound's traffic.
// - A warp's 16 x npad score tile stays in registers (32 n8-tiles x 4 =
//   128 fp32 a thread at npad 256, the limit): the exact row max and sum are
//   two quad shuffles a row, exp2 of the log2e-scaled scores on ex2.approx.
//   The normalised probabilities, packed to bf16, are the A operand of P V
//   against V through ldmatrix.trans, so neither S nor P touches shared
//   memory. The warp's queries and then its bf16 output pass through one
//   16-row staging tile of its own (16-byte loads and stores).
// - One pass, not two: the 128 score registers fit the occupancy that
//   shared memory allows anyway (one double-buffered block of 8 warps an
//   SM, up to 255 registers a thread; ptxas at dh 64: 255 registers, 8
//   bytes of spills; chip_smoke prints its report). Two passes over K (max
//   and sum, then P and P V) would recompute q k^T and every exp for no
//   gain in warps an SM. A first version held to 168 registers for 3
//   blocks of 4 warps an SM spilled about 1 KB a thread at dh 64.
// - Blocks of 8 warps walk consecutive pairs, double-buffered: while a
//   block works on one pair, the next pair's K_h and V_h stream into its
//   second buffer. On the model's path (`group` 1) there is one block an SM
//   (138 KB at n 197, dh 64), each taking ceil(pairs / SMs) pairs; the
//   probe's layouts fix G pairs a block. Where two buffers do not fit (dh 96
//   and up at n 256, n above 176 at dh 128) a block loads each pair after
//   the last. The per-pair arithmetic is the same code, so every launch
//   gives the same bits.
//
// For the probe scripts/exp_vit_attn_kernel.py (K11c; make_headmajor :101,
// make_natural :149): a head-major [b h, n, dh] tensor is the same call with
// b h images of one head and ld_in = ld_out = dh; G = N heads is N whole
// images a block.
#include "attn_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr size_t kMaxSmem = 227 * 1024;

// Shared memory of a block: `buffers` copies of (K_h, V_h), npad rows each
// at a row stride of dh + 8, then one 16-row staging tile a warp.
struct Layout {
  int npad, ld;        // n rounded up to 16; the bf16 row stride
  size_t kv, stage;    // bytes of one K_h (or V_h), of one warp's staging tile
  size_t total;
};

__host__ __device__ inline Layout make_layout(int n, int dh, int buffers) {
  Layout L;
  L.npad = (n + 15) / 16 * 16;
  L.ld = dh + 8;
  L.kv = smem_align((size_t)L.npad * L.ld * sizeof(bf16));
  L.stage = smem_align((size_t)16 * L.ld * sizeof(bf16));
  L.total = 2 * buffers * L.kv + kWarps * L.stage;
  return L;
}

// Start copying K_h and V_h (rows [0, npad) of head columns [0, DH), row
// stride ld_in) into shared memory, 16 bytes a thread per step; rows past n
// are zero-filled.
template <int DH, int THREADS>
__device__ __forceinline__ void load_kv_async(bf16* sK, bf16* sV, const bf16* k, const bf16* v,
                                              int npad, int n, int ld_in, int ld) {
  constexpr int chunks = DH / 8;
  for (int idx = threadIdx.x; idx < npad * chunks; idx += THREADS) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const bool ok = r < n;
    const size_t off = (size_t)r * ld_in + c;
    cp_async16(sK + r * ld + c, ok ? k + off : k, ok);
    cp_async16(sV + r * ld + c, ok ? v + off : v, ok);
  }
}

// One warp's 16 query rows [row0, row0 + 16) of one pair: q and out point at
// the pair's first row and head column (row strides ld_in, ld_out); sK, sV
// its keys and values in shared memory; stage the warp's staging tile.
// c = dh^-0.5 log2(e).
template <int DH>
__device__ __forceinline__ void attend_tile(const bf16* __restrict__ q, bf16* __restrict__ out,
                                            const bf16* sK, const bf16* sV, bf16* stage,
                                            int ld, int n, int npad, int row0, int ld_in,
                                            int ld_out, float c) {
  constexpr int chunks = DH / 8, per_lane = (16 * chunks + 31) / 32;
  const int lane = threadIdx.x % 32;
  const int kt = npad / 16;

  // the queries into the staging tile (zeros past n): every load in flight
  // before the first store
  uint4 qv[per_lane];
#pragma unroll
  for (int i = 0; i < per_lane; ++i) {
    const int idx = lane + 32 * i, r = idx / chunks, col = (idx % chunks) * 8;
    qv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (idx < 16 * chunks && row0 + r < n)
      qv[i] = __ldg(reinterpret_cast<const uint4*>(q + (size_t)(row0 + r) * ld_in + col));
  }
  __syncwarp();  // the previous tile's output has left the staging tile
#pragma unroll
  for (int i = 0; i < per_lane; ++i) {
    const int idx = lane + 32 * i, r = idx / chunks, col = (idx % chunks) * 8;
    if (idx < 16 * chunks) *reinterpret_cast<uint4*>(stage + r * ld + col) = qv[i];
  }
  __syncwarp();

  float o[DH / 8][4];
  attn::attend_rows<DH>(o, stage, sK, sV, ld, n, kt, c);

  // O rounded once, staged over the queries, then 16 bytes a lane
  __syncwarp();
  attn::stage_rows<DH / 8>(stage, ld, o, 1.f, 1.f);
  __syncwarp();
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int r = idx / chunks, col = (idx % chunks) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * ld_out + col) =
          *reinterpret_cast<const uint4*>(stage + r * ld + col);
  }
}

// A block of kWarps warps takes the `group` consecutive (image, head) pairs
// [first, last) of `pairs` (pair = image heads + head). buffers 2: the
// next pair's K_h, V_h load while this pair computes; 1: each pair loads
// after the last.
template <int DH>
__global__ void __launch_bounds__(32 * kWarps, 1)
    vit_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int pairs, int heads,
                    int group, int n, int ld_in, int ld_out, float scale, int buffers) {
  constexpr int THREADS = 32 * kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(n, DH, buffers);
  const int warp = threadIdx.x / 32;
  bf16* stage = reinterpret_cast<bf16*>(smem + 2 * buffers * L.kv + warp * L.stage);
  auto keys = [&](int buf) { return reinterpret_cast<bf16*>(smem + 2 * buf * L.kv); };
  auto values = [&](int buf) { return reinterpret_cast<bf16*>(smem + (2 * buf + 1) * L.kv); };
  auto in_base = [&](int pair) {
    return (size_t)(pair / heads) * n * ld_in + (size_t)(pair % heads) * DH;
  };
  const int first = blockIdx.x * group, last = min(pairs, first + group);
  const int tiles = (n + 15) / 16;
  const float c = scale * attn::kLog2e;

  load_kv_async<DH, THREADS>(keys(0), values(0), k + in_base(first), v + in_base(first),
                             L.npad, n, ld_in, L.ld);
  cp_async_commit();
  for (int pair = first; pair < last; ++pair) {
    const int buf = buffers == 2 ? (pair - first) & 1 : 0;
    if (buffers == 1 && pair > first) {
      __syncthreads();  // every warp is done with the last pair's K_h and V_h
      load_kv_async<DH, THREADS>(keys(0), values(0), k + in_base(pair), v + in_base(pair),
                                 L.npad, n, ld_in, L.ld);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    // past the barrier every warp is done with the pair before: its buffer
    // takes the next pair
    if (buffers == 2 && pair + 1 < last) {
      load_kv_async<DH, THREADS>(keys(buf ^ 1), values(buf ^ 1), k + in_base(pair + 1),
                                 v + in_base(pair + 1), L.npad, n, ld_in, L.ld);
      cp_async_commit();
    }
    const bf16* qp = q + in_base(pair);
    bf16* op = out + (size_t)(pair / heads) * n * ld_out + (size_t)(pair % heads) * DH;
    for (int tile = warp; tile < tiles; tile += kWarps)
      attend_tile<DH>(qp, op, keys(buf), values(buf), stage, L.ld, n, L.npad, 16 * tile, ld_in,
                      ld_out, c);
  }
}

// Two buffers where they fit, else one. group 1 (the model's path): one
// block an SM, each walking its share of the pairs; group G > 1 (the
// probe's layouts): G pairs a block.
template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int pairs, int heads,
                   int group, int n, int ld_in, int ld_out, float scale, cudaStream_t stream) {
  const int buffers = make_layout(n, DH, 2).total <= kMaxSmem ? 2 : 1;
  const size_t smem = make_layout(n, DH, buffers).total;
  cudaError_t err = allow_smem(vit_attn_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  if (group == 1) {
    int device, sms, per_sm;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vit_attn_kernel<DH>,
                                                          32 * kWarps, smem);
    if (err != cudaSuccess) return err;
    const int slots = sms * (per_sm > 0 ? per_sm : 1);
    group = (pairs + slots - 1) / slots;
  }
  vit_attn_kernel<DH><<<(pairs + group - 1) / group, 32 * kWarps, smem, stream>>>(
      q, k, v, out, pairs, heads, group, n, ld_in, ld_out, scale, buffers);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [b, n, *] bf16 with row stride ld_in, head h at columns
// [h dh, (h+1) dh); out: [b, n, *] with row stride ld_out. n <= 256,
// dh a multiple of 16 up to 128, ld_in and ld_out multiples of 8. A block
// takes `group` consecutive (image, head) pairs (1 on the model's path).
MIRROR_EXPORT int mirror_vit_attn(const void* q, const void* k, const void* v, void* out,
                                  int b, int n, int heads, int dh, int ld_in, int ld_out,
                                  int group, float scale, cudaStream_t stream) {
  if (n > 16 * attn::kMaxKeyTiles || dh % 16 != 0 || dh < 16 || dh > 128 || group <= 0)
    return (int)cudaErrorInvalidValue;
  const int pairs = b * heads;
  if (pairs <= 0 || n <= 0) return (int)cudaSuccess;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(out);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dh) {
#define MIRROR_VIT_ATTN_DH(D)                                                              \
  case D:                                                                                  \
    err = launch<D>(qb, kb, vb, ob, pairs, heads, group, n, ld_in, ld_out, scale, stream);    \
    break;
    MIRROR_VIT_ATTN_DH(16)
    MIRROR_VIT_ATTN_DH(32)
    MIRROR_VIT_ATTN_DH(48)
    MIRROR_VIT_ATTN_DH(64)
    MIRROR_VIT_ATTN_DH(80)
    MIRROR_VIT_ATTN_DH(96)
    MIRROR_VIT_ATTN_DH(112)
    MIRROR_VIT_ATTN_DH(128)
#undef MIRROR_VIT_ATTN_DH
  }
  return (int)err;
}
