// The copy floor of device memory: out = in on a bf16 [b, h, n, d] tensor,
// under the launch shapes of the TPU probe (K11a).
//
// Replaces: scripts/exp_hbm_floor.py, its three pallas_calls: copy_floor
// (:54, a block of gb batch rows of one head, gb 8 / 4 / 1, d 96 and 128),
// main.run_flat (:103, a block of the whole batch of one head, grid h) and
// main.run_ntile (:126, a block of 8 batch rows of one head and 384 rows of
// the sequence). Each is the same copy kernel body, o_ref[...] = v_ref[...].
//
// What it computes: dst = src, bit for bit. A block owns gb batch rows of
// one head and `tile` rows of the sequence (grid ceil(b / gb) x h x
// ceil(n / tile)); the part of each batch row it owns is one contiguous run
// of rows x d elements, which its threads copy 16 bytes at a time, four
// loads in flight before the four stores, with a grid-stride over the run.
// Batch rows past b and sequence rows past n are masked, so gb need not
// divide b nor tile divide n.
//
// What bounds it on the H100: bytes, by construction: 2 bytes read and 2
// written per element and no arithmetic. At [64, 8, 2304, 96] that is
// 453 MB, 0.135 ms at 3.35 TB/s (604 MB and 0.180 ms at d 128). The probe
// asks which launch shape comes closest to that, and so what copy rate the
// byte-bound kernels of the port can be read against. The TPU's question
// (what fits VMEM) has no counterpart here; the whole-batch block (grid h,
// 8 blocks on 132 SMs) reads low from occupancy alone, and that reading is
// kept, not dropped.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    copy_floor_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, int b, int h,
                      int n, int chunks_per_row, int gb, int tile) {
  const int head = blockIdx.y;
  const int row0 = blockIdx.z * tile;
  const int rows = min(tile, n - row0);
  const long long run = (long long)rows * chunks_per_row;  // 16-byte chunks of one batch row
  const long long step = (long long)kThreads * kUnroll;
  const int i0 = (int)blockIdx.x * gb, i1 = min(b, i0 + gb);
  for (int i = i0; i < i1; ++i) {
    const size_t base = (((size_t)i * h + head) * n + row0) * chunks_per_row;
    const uint4* s = src + base;
    uint4* o = dst + base;
    for (long long c0 = threadIdx.x; c0 < run; c0 += step) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long c = c0 + (long long)u * kThreads;
        if (c < run) v[u] = s[c];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long c = c0 + (long long)u * kThreads;
        if (c < run) o[c] = v[u];
      }
    }
  }
}

}  // namespace

// dst = src, bf16 [b, h, n, d], d a multiple of 8 (16-byte rows of chunks);
// a block per (gb batch rows, head, tile rows of n).
MIRROR_EXPORT int mirror_copy_floor(const void* src, void* dst, int b, int h, int n, int d,
                                    int gb, int tile, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || gb <= 0 || tile <= 0 ||
      h > 65535 || (n + tile - 1) / tile > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((b + gb - 1) / gb, h, (n + tile - 1) / tile);
  copy_floor_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const uint4*>(src),
                                                    static_cast<uint4*>(dst), b, h, n, d / 8,
                                                    gb, tile);
  return (int)cudaGetLastError();
}
