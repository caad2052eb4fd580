"""The order of work of ``csrc/conv1d.cu`` (kernels 9 and 9b, and kernel
4b's conv) and of the fixed-order column sum (``csrc/common.cuh``),
emulated in plain torch on the CPU and held against the port's plain
versions and the JAX package's Pallas kernel (interpret mode, as the JAX
package's own tests run it), on the same numpy draws from a seed.

- The rows of a (batch, head) in chunks of whole 64-row steps
  (``conv_plan``); chunk row c holds sequence row 64 s0 - K/2 + c, zeros
  outside [0, n).
- The conv (the forward, and dv with the taps flipped): warp w's 16 output
  rows of step k are Band[16, W] . window[64 k + 16 w + j], j < W, with
  Band[r, j] = tap[j - r] for 0 <= j - r < K (W = 16 + K - 1 rounded up to
  16), summed in fp32 and rounded once.
- dkern: warp w of a step takes C[r, s] = g[64 k + 16 w + K/2 + r] .
  v[64 k + 16 w + s] over the features, s < W, added into the warp's sum
  over the chunk's steps; the block's partial is partial[t] = sum over w,
  then r, of Csum_w[r, r + t]; the partials [b chunks, h K] go through the
  column sum.
- The column sum: G contiguous groups of parts, each summed in order, the
  group sums added as a pairwise tree (``column_sum_in_order``, which the
  card's kernel equals bit for bit: ``tests/test_torch_port_cuda.py``).

Bars, those of ``tests/test_torch_port_conv1d.py``: in fp32 the value and
dv within 1e-5 absolute, dkern within 1e-5 of its largest magnitude (sums of
the same products in another order); with bf16 inputs the value and dv
within one bf16 step (2^-7 relative: fp32 sums in another order, rounded
once), dkern fp32 at 1e-5 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mirror_tpu.ops.conv1d_pallas import depthwise_conv1d_seq as jax_conv
from mirror_tpu_torch.ops import conv1d
from mirror_tpu_torch.ops.conv1d import (band_width, column_sum_groups, column_sum_in_order,
                                         conv_plan, depthwise_conv_seq_bwd_ref,
                                         depthwise_conv_seq_ref)
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

STEP, WARP_ROWS, WARPS = 64, 16, 4
BF16_STEP = 2.0 ** -7


def _padded(x, ksize, per, chunks):
    """x [b, h, n, d] in fp32 with K/2 zero rows before it and enough after
    it for every chunk's last stage: sequence row q at row q + K/2."""
    n, half = x.shape[2], ksize // 2
    rows = per * chunks * STEP + band_width(ksize)
    return F.pad(x.float(), (0, 0, half, rows - n))


def band(taps):
    """Band[h, 16, W]: row r holds the taps at columns r .. r + K - 1."""
    h, ksize = taps.shape
    out = torch.zeros(h, WARP_ROWS, band_width(ksize))
    for r in range(WARP_ROWS):
        out[:, r, r:r + ksize] = taps.float()
    return out


def conv_emulation(x, taps):
    """out = conv(x, taps) in the kernel's order of work: chunks of 64-row
    steps, 16 rows a warp, each the band product of its window rows, fp32,
    rounded once to x's dtype."""
    b, h, n, d = x.shape
    ksize = taps.shape[1]
    per, chunks = conv_plan(b * h, n)
    steps = -(-n // STEP)
    xp, bnd = _padded(x, ksize, per, chunks), band(taps)
    width = bnd.shape[-1]
    out = torch.zeros(b, h, steps * STEP, d)
    for chunk in range(chunks):
        s0 = chunk * per
        for k in range(min(per, steps - s0)):
            for w in range(WARPS):
                c0 = STEP * k + WARP_ROWS * w  # chunk row; its padded row is 64 s0 + c0
                win = xp[:, :, STEP * s0 + c0:STEP * s0 + c0 + width]
                i0 = STEP * (s0 + k) + WARP_ROWS * w
                out[:, :, i0:i0 + WARP_ROWS] = bnd @ win
    return out[:, :, :n].to(x.dtype)


def dkern_partials(v, g, ksize):
    """The fused backward's dkern partials [b chunks, h K]: per chunk, each
    warp's Toeplitz sums over the steps, then the diagonal sums over w and r
    in order."""
    b, h, n, d = v.shape
    per, chunks = conv_plan(b * h, n)
    steps, half = -(-n // STEP), ksize // 2
    vp, gp = _padded(v, ksize, per, chunks), _padded(g, ksize, per, chunks)
    width = band_width(ksize)
    partial = torch.zeros(b, chunks, h, ksize)
    for chunk in range(chunks):
        s0 = chunk * per
        csum = torch.zeros(b, h, WARPS, WARP_ROWS, width)
        for k in range(min(per, steps - s0)):
            for w in range(WARPS):
                c0 = STEP * (s0 + k) + WARP_ROWS * w
                a = gp[:, :, c0 + half:c0 + half + WARP_ROWS]  # g rows 64(s0+k) + 16w + r
                bt = vp[:, :, c0:c0 + width]  # v rows 64(s0+k) + 16w + s - K/2
                csum[:, :, w] += a @ bt.transpose(-1, -2)
        for t in range(ksize):
            acc = torch.zeros(b, h)
            for w in range(WARPS):
                for r in range(WARP_ROWS):
                    acc = acc + csum[:, :, w, r, r + t]
            partial[:, chunk, :, t] = acc
    return partial.reshape(b * chunks, h * ksize)


def bwd_emulation(v, taps, g):
    """(dv, dkern) in the kernel's order of work: dv the band product of g
    with the flipped taps, dkern the column sum of the block partials."""
    h, ksize = taps.shape
    dv = conv_emulation(g, taps.flip(-1))
    dkern = column_sum_in_order(dkern_partials(v, g, ksize)).reshape(h, ksize)
    return dv, dkern


def _draws(seed, b, h, n, d, ksize):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, h, n, d)).astype(np.float32)
    kern = (0.1 * rng.standard_normal((h, ksize))).astype(np.float32)
    t = rng.standard_normal((b, h, n, d)).astype(np.float32)
    return v, kern, t


def _jax(v, kern, t, v_dtype):
    def loss(v, k):
        return jnp.sum(jax_conv(v, k).astype(jnp.float32) * t)

    vj = jnp.asarray(v).astype(v_dtype)
    out = jax_conv(vj, jnp.asarray(kern))
    dv, dk = jax.grad(loss, argnums=(0, 1))(vj, jnp.asarray(kern))
    return [np.asarray(a, np.float32) for a in (out, dv, dk)]


def _close_dkern(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# (b, h, n, d, K): n <= K/2; d 8 with K 7 over 2 chunks of 6 steps, the last
# one of 5 (n 700 a multiple of neither 64 nor the chunk); K 65 at d 128; d
# 96 at K 33 with a short last step; one chunk a (batch, head) (b h >= 264)
SHAPES = [(2, 3, 10, 16, 33), (16, 8, 700, 8, 7), (1, 2, 200, 128, 65), (2, 3, 140, 96, 33),
          (64, 8, 150, 8, 33)]


@pytest.mark.parametrize("b,h,n,d,ksize", SHAPES)
def test_conv_order_of_work_matches_plain_and_pallas_fp32(b, h, n, d, ksize):
    v, kern, t = _draws(b * 7 + n, b, h, n, d, ksize)
    vt, kt, gt = map(torch.from_numpy, (v, kern, t))
    out = conv_emulation(vt, kt)
    dv, dkern = bwd_emulation(vt, kt, gt)
    out_ref = depthwise_conv_seq_ref(vt, kt)
    dv_ref, dkern_ref = depthwise_conv_seq_bwd_ref(vt, kt, gt)
    np.testing.assert_allclose(out.numpy(), out_ref.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), dv_ref.numpy(), rtol=0, atol=1e-5)
    _close_dkern(dkern.numpy(), dkern_ref.numpy())
    out_j, dv_j, dk_j = _jax(v, kern, t, jnp.float32)
    np.testing.assert_allclose(out.numpy(), out_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), dv_j, rtol=0, atol=1e-5)
    _close_dkern(dkern.numpy(), dk_j)


@pytest.mark.parametrize("b,h,n,d,ksize", [(2, 3, 130, 16, 33), (4, 2, 90, 8, 65)])
def test_conv_order_of_work_bf16_matches_plain_and_pallas(b, h, n, d, ksize):
    """bf16 v and g, taps rounded to bf16 (the kernel's inputs): the value
    and dv within one bf16 step, dkern at 1e-5 of its largest magnitude."""
    v, kern, t = _draws(b * 11 + n, b, h, n, d, ksize)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    taps = torch.from_numpy(kern).to(torch.bfloat16)
    gt = torch.from_numpy(t).to(torch.bfloat16)
    out = conv_emulation(vt, taps)
    dv, dkern = bwd_emulation(vt, taps, gt)
    assert out.dtype == dv.dtype == torch.bfloat16
    out_ref = depthwise_conv_seq_ref(vt, taps).to(torch.bfloat16)
    dv_ref, dkern_ref = depthwise_conv_seq_bwd_ref(vt, taps, gt)
    out_j, dv_j, dk_j = _jax(v, kern, t, jnp.bfloat16)
    for got, refs in ((out, (out_ref, out_j)), (dv, (dv_ref.to(torch.bfloat16), dv_j))):
        for ref in refs:
            np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32)
                                       if not isinstance(ref, torch.Tensor)
                                       else ref.float().numpy(), rtol=BF16_STEP, atol=1e-6)
    _close_dkern(dkern.numpy(), dkern_ref.numpy())
    _close_dkern(dkern.numpy(), dk_j)


@pytest.mark.parametrize("bh,n,want", [
    (128, 2117, (17, 2)),  # phase 3's [16, 8, 2117, 96]: 34 steps in 2 chunks of 17
    (128, 2304, (18, 2)),  # kernel 4b's conv at the padded length r 2304
    (512, 2304, (36, 1)),  # the probe's b 64: one chunk a (batch, head)
    (6, 140, (1, 3)),      # few rows: a chunk a step
    (4, 10, (1, 1)),       # n <= K/2: one step
    (128, 700, (6, 2)),    # a shorter last chunk (5 of 6 steps)
    (100, 700, (6, 2)),    # 2 x 100 blocks within the wave of 264
])
def test_conv_plan_chunks(bh, n, want):
    per, chunks = conv_plan(bh, n)
    steps = -(-n // STEP)
    assert (per, chunks) == want
    assert (chunks - 1) * per < steps <= chunks * per  # every chunk holds a step
    assert bh * chunks <= max(conv1d.WAVE_BLOCKS, bh)  # one wave of the backward


@pytest.mark.parametrize("ksize,width", [(1, 16), (7, 32), (17, 32), (19, 48), (33, 48),
                                         (65, 80)])
def test_band_width_covers_the_taps(ksize, width):
    """W covers the 16 + K - 1 window rows of a warp's outputs, in whole
    16-column tiles; the band's row r holds the taps at columns r .. r + K
    - 1."""
    assert band_width(ksize) == width and width >= 16 + ksize - 1 > width - 16
    taps = torch.arange(1, ksize + 1, dtype=torch.float32).reshape(1, ksize)
    bnd = band(taps)[0]
    for r in range(WARP_ROWS):
        assert torch.equal(bnd[r, r:r + ksize], taps[0])
        assert bnd[r].count_nonzero() == ksize


# (nparts, count, G): the call sites' shapes, and edges
@pytest.mark.parametrize("nparts,count,groups", [
    (1152, 264, 64),      # the former conv partials at b 64
    (288, 264, 64),       # and at b 16
    (32, 264, 8),         # this conv's partials at [16, 8, 2117, 96] (b 16 x 2 chunks)
    (64, 264, 16),        # and at b 64 (one chunk a (batch, head))
    (96, 38400, 8),       # kernel 5b's dk / db
    (7, 1769472, 1),      # kernel 10b's gw, into bf16
    (530, 1536, 64),      # 10b's gs / gb, ln_blocks(16 x 2117)
    (1, 99, 1),           # one part
    (7, 5, 1),            # fewer than 8 parts: never split
    (8, 5, 2),            # 8 parts: two groups of 4
])
def test_column_sum_groups(nparts, count, groups):
    assert column_sum_groups(nparts, count) == groups


# (nparts, count): the tall and wide regimes, counts not a multiple of 4,
# one part, a last group shorter than the rest and empty groups
@pytest.mark.parametrize("nparts,count", [(1152, 264), (288, 99), (96, 3840), (7, 4099),
                                          (1, 99), (9, 5), (37, 1), (530, 1536)])
def test_column_sum_in_order_matches_the_sum(nparts, count):
    """The grouped order sums every part of a column once: within 1e-6 of
    the float64 sum, relative to the column's sum of magnitudes."""
    rng = np.random.default_rng(nparts * 31 + count)
    parts = torch.from_numpy(rng.standard_normal((nparts, count)).astype(np.float32))
    got = column_sum_in_order(parts)
    want = parts.double().sum(0)
    scale = parts.double().abs().sum(0)
    assert got.dtype == torch.float32 and got.shape == (count,)
    assert ((got.double() - want).abs() <= 1e-6 * scale).all()


def test_column_sum_in_order_is_the_documented_tree():
    """Eight parts, spelled out: G = 2 groups of 4, the group sums
    ((p0 + p1) + p2) + p3 and ((p4 + p5) + p6) + p7 from 0, then their
    sum."""
    parts = torch.tensor([[1e8], [1.0], [-1e8], [1.0], [3.0], [1e-8], [5.0], [7.0]])
    assert column_sum_groups(8, 1) == 2
    g0 = ((0.0 + parts[0] + parts[1]) + parts[2]) + parts[3]
    g1 = ((0.0 + parts[4] + parts[5]) + parts[6]) + parts[7]
    assert torch.equal(column_sum_in_order(parts), (g0 + g1).float())
    assert column_sum_in_order(parts).item() == 16.0  # the 1.0 after 1e8 is lost in fp32


def test_conv_plain_path_is_the_plain_version():
    """On CPU tensors the autograd Function and the dv entry run the plain
    versions (nothing of the emulation): the emulation is a model of the
    card's kernel, not of the CPU path."""
    v, kern, t = _draws(3, 1, 2, 50, 8, 7)
    vt, kt, gt = map(torch.from_numpy, (v, kern, t))
    assert torch.equal(conv1d.depthwise_conv1d_seq(vt, kt), depthwise_conv_seq_ref(vt, kt))
    assert torch.equal(conv1d.conv1d_bwd_dv(gt, kt), conv1d.conv1d_bwd_dv_ref(gt, kt))
    assert torch.equal(conv1d.column_sum(gt[0, 0]), conv1d.column_sum_ref(gt[0, 0]))
