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
// ceil(n / tile)), the TPU grid's cells; the part of each batch row it owns
// is one contiguous run of rows x d elements. Batch rows past b and
// sequence rows past n are masked, so gb need not divide b nor tile divide
// n.
//
// What bounds it on the H100: bytes, by construction: 2 bytes read and 2
// written per element and no arithmetic. At [64, 8, 2304, 96] that is
// 453 MB, 0.135 ms at 3.35 TB/s (604 MB and 0.180 ms at d 128). The probe
// asks which launch shape comes closest to that, and so what copy rate the
// byte-bound kernels of the port can be read against. The TPU's question
// (what fits VMEM) has no counterpart here.
//
// Design: a ring of 1-D bulk copies (TMA), driven by one thread a block.
// The grid keeps the TPU's cells, so at gb 8 only 64 blocks run on 132
// SMs, and each has to keep far more bytes in flight than a register copy
// can (device memory at about 1 us of latency needs about 3 MB in flight
// across the card): the block's runs are cut into pieces of at most
// kStageBytes (the last piece of a run ragged, a multiple of 16 bytes as
// d % 8 == 0 makes every row), each piece is one bulk load into a stage of
// shared memory, counted in by the stage's mbarrier, and one bulk store
// back out; a stage is loaded again once the store from it has read it
// (cp.async.bulk.wait_group.read). The ring is kStages stages of
// kStageBytes: 3 loads (144 KB) and a store or two in flight a block.
// ops/copy_floor.py::copy_plan is the same walk in Python, and its test
// holds the pieces to cover every byte once.
// Bulk copies need 16-byte sizes and addresses: the entry refuses a
// misaligned pointer rather than copy it some other way. The whole-batch
// block (grid h, 8 blocks on 132 SMs) reads low from occupancy alone, and
// that reading is kept, not dropped.
//
// Measured (H100 80GB HBM3, 700 W; the probe exp_hbm_floor at [64, 8, 2304,
// 96]): gb 8 0.1746-0.1765 ms against the register copy's 0.2077-0.2080 in
// the same call and dst.copy_(src)'s 0.1523-0.1525: 1.15x the library
// copy, not the 1.05x aimed at. Not a limit of one SM: the same blocks on
// 16 SMs (the first 16 batch rows) move 93 GB/s each, on 32 SMs 79, on
// 64 (gb 8) 40; with more blocks (gb 4, gb 1, 384-row tiles) the ring
// reaches 2.74-2.80 TB/s, 1.06-1.09x the library copy. Two threads a block
// each driving half the ring, an L2 evict-first policy on the bulk copies,
// and rings of 2 x 48 KB or 3 x 24 KB read the same or slower at gb 8. The
// whole-batch block (8 blocks): 0.5677-0.5715 ms (0.9802-0.9820 before).
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 4;
constexpr unsigned kStageBytes = 48 * 1024;  // a multiple of 16
constexpr size_t kSmem = kStages * (kStageBytes + sizeof(uint64_t));

__global__ void __launch_bounds__(32, 1)
    copy_floor_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
                      int b, int h, int n, int row_bytes, int gb, int tile) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * (size_t)kStageBytes);
  if (threadIdx.x != 0) return;
  for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
  fence_mbar_init();

  const int head = blockIdx.y;
  const int row0 = blockIdx.z * tile;
  const long long run = (long long)min(tile, n - row0) * row_bytes;  // bytes of one batch row
  const int per = (int)((run + kStageBytes - 1) / kStageBytes);        // pieces of a run
  const int i0 = (int)blockIdx.x * gb, i1 = min(b, i0 + gb);
  const int total = (i1 - i0) * per;
  // piece k: run i0 + k / per, its (k % per)-th kStageBytes
  auto piece = [&](int k, size_t* off, unsigned* bytes) {
    const int i = i0 + k / per, j = k % per;
    *off = (((size_t)i * h + head) * n + row0) * row_bytes + (size_t)j * kStageBytes;
    *bytes = (unsigned)min((long long)kStageBytes, run - (long long)j * kStageBytes);
  };
  auto load = [&](int k) {
    const int s = k % kStages;
    size_t off;
    unsigned bytes;
    piece(k, &off, &bytes);
    mbar_expect_tx(&full[s], bytes);
    bulk_load(smem + (size_t)s * kStageBytes, src + off, bytes, &full[s]);
  };

  for (int k = 0; k < kStages && k < total; ++k) load(k);
  for (int k = 0; k < total; ++k) {
    const int s = k % kStages;
    mbar_wait(&full[s], (k / kStages) & 1);
    size_t off;
    unsigned bytes;
    piece(k, &off, &bytes);
    bulk_store(dst + off, smem + (size_t)s * kStageBytes, bytes);
    // the store of piece k - 1 has read its stage: it takes piece k - 1 + kStages
    if (k >= 1 && k - 1 + kStages < total) {
      bulk_wait_read<1>();
      load(k - 1 + kStages);
    }
  }
  bulk_wait_all();
}

}  // namespace

// dst = src, bf16 [b, h, n, d], d a multiple of 8 (16-byte rows), both
// pointers 16-byte aligned; a block per (gb batch rows, head, tile rows of
// n).
MIRROR_EXPORT int mirror_copy_floor(const void* src, void* dst, int b, int h, int n, int d,
                                    int gb, int tile, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || gb <= 0 || tile <= 0 ||
      h > 65535 || (n + tile - 1) / tile > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaError_t err = allow_smem(copy_floor_kernel, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + gb - 1) / gb, h, (n + tile - 1) / tile);
  copy_floor_kernel<<<grid, 32, kSmem, stream>>>(static_cast<const unsigned char*>(src),
                                                 static_cast<unsigned char*>(dst), b, h, n, d * 2,
                                                 gb, tile);
  return (int)cudaGetLastError();
}
