"""The arithmetic of two CUDA kernels' designs, emulated in plain torch on
the CPU and held against the port's plain versions and the JAX package's
Pallas kernels (interpret mode, as the JAX package's own tests run them).

- Kernel 8 (``csrc/vit_attn.cu``): a block owns an (image, head) pair and
  walks all of its 16-row query tiles; a tile's scores are fp32 over the
  keys rounded up to 16 (zero rows), columns past n are -inf, the row max
  and sum are exact, the weights are exp2 of log2(e)-scaled scores (the
  kernel's ex2.approx), normalised by the sum's reciprocal, rounded to
  bf16, and P v is summed in fp32 and rounded once.
- Kernel 5 (``csrc/ppeg.cu``): a block takes 64 channels of a band of 8
  grid rows and walks it in chunks of 16 columns, each chunk staged with
  its 3-pixel halo (zeros outside the image); a lane owns a channel pair;
  each output starts at img + b in fp32 and adds its 49 taps in (dy, dx)
  order (fmaf of two bf16 values is exact in its product, so fp32
  multiply-adds here give the kernel's bits), rounded once.
- Kernel 5b (``csrc/ppeg.cu``): one pass writes dimg (g plus the flipped
  conv of g, summed in (dy, dx) order, one rounding) and one [50, C] fp32
  partial of dk and db per (image, band of 8 grid rows), summed over the
  band's 16-column chunks; a second pass sums the partials in the column
  sum's fixed order (``csrc/common.cuh``, ``column_sum_in_order``: G
  contiguous groups of partials, each summed in order, then the group sums
  added as a pairwise tree).

Tolerances, with their reasons:
- attention: relative Frobenius error 1e-2 (BOUND_VIT of the CUDA tests).
  The emulation and the plain version round P and the output to bf16 at
  the same points, but from fp32 values that differ in their last bits
  (exp2 against exp, a reciprocal against a division, sums in another
  order), so a few values land one bf16 ulp (2^-8 relative) apart;
- PPEG forward, bf16 inputs against ``ppeg_ref`` (an fp32 conv summed in
  another order): relative Frobenius error 1e-3 (a few values one bf16 ulp
  apart); against the plain (dy, dx)-order sum over the whole image: bit
  for bit (the bands, chunks and channel blocks do not change an output's
  arithmetic);
- PPEG, fp32 inputs: max abs error 1e-5 of the largest magnitude, the bar
  tests/test_torch_port_grads.py holds the port's backward to against the
  Pallas VJP (sums of the same products in another order);
- PPEG, bf16 inputs against ``ppeg_bwd_ref``: dk and db, fp32, the same
  1e-5; dimg, rounded once to bf16 from fp32 sums taken in another order,
  relative Frobenius error 1e-3 (a few values one ulp apart).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mirror_tpu.ops.ppeg_pallas import ppeg_fused as jax_ppeg_fused
from mirror_tpu.ops.vit_attn_pallas import mha_natural as jax_mha_natural
from mirror_tpu_torch.ops.conv1d import column_sum_in_order
from mirror_tpu_torch.ops.ppeg import KSIZE, ppeg_bwd_ref, ppeg_ref
from mirror_tpu_torch.ops.vit_attn import mha_natural_ref
from test_torch_port_cuda import ppeg_dydx_order
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

LOG2E = 1.4426950408889634
TILE = 16  # kernel 8's query and key tiles
BAND, CHUNK = 8, 16  # kernels 5 and 5b's band rows, chunk columns
CBLOCK = 64  # kernel 5's channels a block (a pair a lane)
BOUND_ATTN, BOUND_FP32, BOUND_DIMG_BF16 = 1e-2, 1e-5, 1e-3


def _rel_fro(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _max_rel(a, b):
    a, b = (torch.from_numpy(np.array(t, np.float32)) for t in (a, b))
    return ((a - b).abs().max() / b.abs().max()).item()


# ---------------------------------------------------------------------------
# kernel 8
# ---------------------------------------------------------------------------


def kernel8_emulation(q, k, v, heads):
    """Kernel 8's order of work on bf16 q, k, v [b, n, d]."""
    b, n, d = q.shape
    dh = d // heads
    npad = math.ceil(n / TILE) * TILE
    c = torch.tensor(dh ** -0.5 * LOG2E, dtype=torch.float32)

    def pairs(t):  # [b heads, npad, dh]: a block's pair, zero rows past n
        t = t.reshape(b, n, heads, dh).transpose(1, 2).reshape(b * heads, n, dh)
        return F.pad(t, (0, 0, 0, npad - n)).float()

    qp, kp, vp = pairs(q), pairs(k), pairs(v)
    out = torch.empty(b * heads, npad, dh, dtype=q.dtype)
    for row0 in range(0, npad, TILE):  # every query tile of every pair
        s = qp[:, row0:row0 + TILE] @ kp.transpose(1, 2)  # fp32 [pairs, 16, npad]
        s[..., n:] = -math.inf
        m = s.amax(-1, keepdim=True)
        e = torch.exp2(s * c - m * c)
        p = (e * (1.0 / e.sum(-1, keepdim=True))).to(torch.bfloat16)
        out[:, row0:row0 + TILE] = (p.float() @ vp).to(q.dtype)
    return out[:, :n].reshape(b, heads, n, dh).transpose(1, 2).reshape(b, n, d)


@pytest.mark.parametrize("b,n,heads,dh", [(1, 197, 2, 64), (2, 37, 3, 16), (1, 256, 1, 128),
                                          (2, 16, 2, 64), (1, 1, 2, 16)])
def test_kernel8_order_of_work_matches_plain_and_pallas(b, n, heads, dh):
    rng = np.random.default_rng(90)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads * dh), np.float32))
               .to(torch.bfloat16) for _ in range(3))
    got = kernel8_emulation(q, k, v, heads)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert _rel_fro(got, mha_natural_ref(q, k, v, heads)) <= BOUND_ATTN
    want = jax_mha_natural(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                           heads)
    assert _rel_fro(got, torch.from_numpy(np.asarray(want, np.float32))) <= BOUND_ATTN


# ---------------------------------------------------------------------------
# kernel 5b
# ---------------------------------------------------------------------------


def kernel5b_emulation(img, kern, g):
    """(dimg, dk, db) in kernel 5b's order of work: dimg in img's dtype, dk
    [7, 7, C] and db [C] fp32."""
    b, H, W, C = img.shape
    half = KSIZE // 2
    g32, kf = g.float(), kern.float().flip(0, 1)
    gp = F.pad(g32, (0, 0, half, half, half, half))
    dimg = g32.clone()
    for dy in range(KSIZE):  # each output sums its taps in (dy, dx) order
        for dx in range(KSIZE):
            dimg = dimg + kf[dy, dx] * gp[:, dy:dy + H, dx:dx + W]
    ip = F.pad(img.float(), (0, 0, half, half, half, half))
    bands = math.ceil(H / BAND)
    partial = torch.zeros(b * bands, KSIZE * KSIZE + 1, C)
    for i in range(b):
        for band in range(bands):
            y0, y1 = band * BAND, min(H, band * BAND + BAND)
            acc = torch.zeros(KSIZE * KSIZE + 1, C)
            for x0 in range(0, W, CHUNK):  # the band's chunks, in turn
                x1 = min(W, x0 + CHUNK)
                gb = g32[i, y0:y1, x0:x1]
                for dy in range(KSIZE):
                    for dx in range(KSIZE):
                        win = ip[i, y0 + dy:y1 + dy, x0 + dx:x1 + dx]
                        acc[dy * KSIZE + dx] += (gb * win).sum((0, 1))
                acc[-1] += gb.sum((0, 1))
            partial[i * bands + band] = acc
    total = column_sum_in_order(partial.reshape(b * bands, -1)).reshape(KSIZE * KSIZE + 1, C)
    return dimg.to(img.dtype), total[:-1].reshape(KSIZE, KSIZE, C), total[-1]


# (b, H, W, C): H not a multiple of the 8-row band, W not of the 16-column
# chunk, C not of the 64-channel block; 9 partials in the last (the column
# sum's two groups, the second shorter)
PPEG_SHAPES = [(2, 13, 21, 40), (1, 9, 18, 72), (3, 17, 35, 8)]


@pytest.mark.parametrize("b,H,W,C", PPEG_SHAPES[::2])  # each interpret-mode VJP takes ~3 s
def test_kernel5b_band_partials_match_pallas_vjp(b, H, W, C):
    rng = np.random.default_rng(91)
    img, g = (rng.standard_normal((b, H, W, C), np.float32) for _ in range(2))
    kern = 0.1 * rng.standard_normal((KSIZE, KSIZE, C), np.float32)
    bias = 0.1 * rng.standard_normal((C,), np.float32)
    _, vjp = jax.vjp(jax_ppeg_fused, *map(jnp.asarray, (img, kern, bias)))
    want = vjp(jnp.asarray(g))
    got = kernel5b_emulation(*map(torch.from_numpy, (img, kern, g)))
    for name, a, w in zip(("dimg", "dk", "db"), got, want):
        assert a.shape == w.shape, name
        assert _max_rel(a, w) <= BOUND_FP32, name


@pytest.mark.parametrize("b,H,W,C", PPEG_SHAPES)
def test_kernel5b_band_partials_match_plain_in_bf16(b, H, W, C):
    rng = np.random.default_rng(92)
    img, g = (torch.from_numpy(rng.standard_normal((b, H, W, C), np.float32))
              .to(torch.bfloat16) for _ in range(2))
    kern = torch.from_numpy(0.1 * rng.standard_normal((KSIZE, KSIZE, C), np.float32)) \
        .to(torch.bfloat16)
    dimg, dk, db = kernel5b_emulation(img, kern, g)
    ref = ppeg_bwd_ref(img, kern, g)
    assert dimg.dtype == torch.bfloat16
    assert _rel_fro(dimg, ref[0]) <= BOUND_DIMG_BF16
    assert _max_rel(dk, ref[1]) <= BOUND_FP32
    assert _max_rel(db, ref[2]) <= BOUND_FP32


# ---------------------------------------------------------------------------
# kernel 5
# ---------------------------------------------------------------------------


def kernel5_emulation(img, kern, bias):
    """out in kernel 5's order of work: per (image, 64-channel block, band
    of 8 rows, 16-column chunk), the chunk with its halo staged (zeros
    outside the image), each output from img + b, then the taps in (dy, dx)
    order, one rounding to img's dtype."""
    b, H, W, C = img.shape
    half = KSIZE // 2
    x32, k32, b32 = img.float(), kern.float(), bias.float()
    out = torch.empty(b, H, W, C, dtype=img.dtype)
    for i in range(b):
        for c0 in range(0, C, CBLOCK):
            c1 = min(C, c0 + CBLOCK)
            for y0 in range(0, H, BAND):
                y1 = min(H, y0 + BAND)
                for x0 in range(0, W, CHUNK):
                    x1 = min(W, x0 + CHUNK)
                    tile = torch.zeros(BAND + 2 * half, CHUNK + 2 * half, c1 - c0)
                    ys, xs = max(0, y0 - half), max(0, x0 - half)
                    ye, xe = min(H, y0 + BAND + half), min(W, x0 + CHUNK + half)
                    tile[ys - y0 + half:ye - y0 + half, xs - x0 + half:xe - x0 + half] = \
                        x32[i, ys:ye, xs:xe, c0:c1]
                    rows, cols = y1 - y0, x1 - x0
                    acc = tile[half:half + rows, half:half + cols] + b32[c0:c1]
                    for dy in range(KSIZE):
                        for dx in range(KSIZE):
                            acc = acc + k32[dy, dx, c0:c1] * tile[dy:dy + rows, dx:dx + cols]
                    out[i, y0:y1, x0:x1, c0:c1] = acc.to(img.dtype)
    return out


# (b, H, W, C): H not a multiple of the 8-row band, W not of the 16-column
# chunk, C not of the 64-channel block (and above it), odd C
PPEG_FWD_SHAPES = [(2, 13, 21, 40), (1, 9, 35, 72), (1, 11, 19, 37)]


def _ppeg_fwd_inputs(seed, b, H, W, C):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, H, W, C), np.float32)
    kern = 0.1 * rng.standard_normal((KSIZE, KSIZE, C), np.float32)
    bias = 0.1 * rng.standard_normal((C,), np.float32)
    return img, kern, bias


@pytest.mark.parametrize("b,H,W,C", PPEG_FWD_SHAPES)
def test_kernel5_order_of_work_matches_plain_in_bf16(b, H, W, C):
    img, kern, bias = (torch.from_numpy(t).to(torch.bfloat16)
                       for t in _ppeg_fwd_inputs(93, b, H, W, C))
    got = kernel5_emulation(img, kern, bias)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ppeg_dydx_order(img, kern, bias))
    assert _rel_fro(got, ppeg_ref(img, kern, bias)) <= BOUND_DIMG_BF16


@pytest.mark.parametrize("b,H,W,C", PPEG_FWD_SHAPES[::2])
def test_kernel5_order_of_work_matches_pallas(b, H, W, C):
    img, kern, bias = _ppeg_fwd_inputs(94, b, H, W, C)
    want = jax_ppeg_fused(*map(jnp.asarray, (img, kern, bias)))
    got = kernel5_emulation(*map(torch.from_numpy, (img, kern, bias)))
    assert got.shape == want.shape
    assert _max_rel(got, want) <= BOUND_FP32
