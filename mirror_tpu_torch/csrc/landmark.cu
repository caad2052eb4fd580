// Landmark means and landmark softmax of the Nystrom attention (K1).
//
// Replaces: mirror_tpu/ops/landmark_pallas.py::landmark_softmax (forward
// pallas_call in _fwd_call).
//
// What it computes, per (batch, head): q_l, k_l = means over contiguous
// groups of l rows of the virtually FRONT-PADDED sequence (real row i lies
// in group (i + pad) / l, the divisor is always l, groups made only of pad
// rows are exactly 0), rounded to bf16; then attn2 = softmax(q_l k_l^T)
// with fp32 statistics, rounded to bf16.
//
// What bounds it on the H100: bytes. At the slice's shape it reads q and k
// once (2 x 16x8x2117x96 bf16 = 52 MB) and does ~1.8 GFLOP for the m x m
// similarity, far below the tensor-core line.
//
// Design: two launches in one entry point. The TPU program keeps the q/k
// rows, the group means and the whole [m, m] softmax of one (batch, head) in
// VMEM at once; a Hopper block cannot hold k_l and the q rows together with
// the similarity rows, and one block per (batch, head) would leave most of
// the 132 SMs idle. (1) the means kernel gives one thread per (group,
// feature) and reads each real row once, coalesced along dh; (2) the
// softmax kernel keeps the k_l of one (batch, head) in shared memory (rows
// padded by one bf16 pair so the lanes of a warp, which read different rows
// at the same feature, hit different banks) and gives one warp per q_l row:
// the warp computes the m similarities into shared memory, reduces max and
// sum with shuffles, and writes the row once.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per landmark row

__global__ void landmark_means_kernel(const bf16* __restrict__ q,
                                      const bf16* __restrict__ k,
                                      bf16* __restrict__ q_l,
                                      bf16* __restrict__ k_l,
                                      int n, int dh, int m, int l, int pad) {
  const int g = blockIdx.x;    // landmark group
  const int bh = blockIdx.y;   // batch * heads + head
  const float inv_l = 1.0f / (float)l;
  const size_t in_base = (size_t)bh * n * dh;
  const size_t out_base = ((size_t)bh * m + g) * dh;
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float sq = 0.f, sk = 0.f;
    for (int j = 0; j < l; ++j) {
      const int row = g * l - pad + j;  // pad rows (row < 0) are zeros
      if (row >= 0 && row < n) {
        sq += __bfloat162float(q[in_base + (size_t)row * dh + d]);
        sk += __bfloat162float(k[in_base + (size_t)row * dh + d]);
      }
    }
    q_l[out_base + d] = __float2bfloat16(sq * inv_l);
    k_l[out_base + d] = __float2bfloat16(sk * inv_l);
  }
}

__global__ void landmark_softmax_kernel(const bf16* __restrict__ q_l,
                                        const bf16* __restrict__ k_l,
                                        bf16* __restrict__ attn, int m,
                                        int dh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = dh + 2;  // bf16 elements per k_l row in shared memory
  bf16* sK = reinterpret_cast<bf16*>(smem);
  float* sQ = reinterpret_cast<float*>(smem + smem_align((size_t)m * ldk * sizeof(bf16)));
  float* sSim = sQ + kRowsPerBlock * dh;

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kb = k_l + (size_t)bh * m * dh;
  for (int idx = threadIdx.x; idx < m * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx % dh;
    sK[j * ldk + d] = kb[idx];
  }
  const int row = blockIdx.x * kRowsPerBlock + warp;
  float* q_row = sQ + warp * dh;
  float* sim = sSim + (size_t)warp * m;
  if (row < m) {
    const bf16* qb = q_l + ((size_t)bh * m + row) * dh;
    for (int d = lane; d < dh; d += 32) q_row[d] = __bfloat162float(qb[d]);
  }
  __syncthreads();
  if (row >= m) return;

  float mx = -INFINITY;
  for (int j = lane; j < m; j += 32) {
    const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(sK + j * ldk);
    float s = 0.f;
    for (int d2 = 0; d2 < dh / 2; ++d2) {
      const float2 kv = __bfloat1622float2(kr[d2]);
      s = fmaf(q_row[2 * d2], kv.x, s);
      s = fmaf(q_row[2 * d2 + 1], kv.y, s);
    }
    sim[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < m; j += 32) {
    const float e = expf(sim[j] - mx);
    sim[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  const float inv = 1.0f / sum;
  bf16* out = attn + ((size_t)bh * m + row) * m;
  for (int j = lane; j < m; j += 32) out[j] = __float2bfloat16(sim[j] * inv);
}

}  // namespace

MIRROR_EXPORT int mirror_landmark_softmax(const void* q, const void* k, void* q_l,
                                          void* k_l, void* attn2, int bh, int n,
                                          int dh, int m, int l, int pad,
                                          cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  bf16* qlp = static_cast<bf16*>(q_l);
  bf16* klp = static_cast<bf16*>(k_l);
  landmark_means_kernel<<<dim3(m, bh), 128, 0, stream>>>(qp, kp, qlp, klp, n, dh, m,
                                                          l, pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_align((size_t)m * (dh + 2) * sizeof(bf16)) +
                      (size_t)kRowsPerBlock * dh * sizeof(float) +
                      (size_t)kRowsPerBlock * m * sizeof(float);
  err = allow_smem(landmark_softmax_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  landmark_softmax_kernel<<<grid, 32 * kRowsPerBlock, smem, stream>>>(
      qlp, klp, static_cast<bf16*>(attn2), m, dh);
  return (int)cudaGetLastError();
}
