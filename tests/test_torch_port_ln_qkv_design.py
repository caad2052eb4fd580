"""Kernels 10 and 10b's order of work (``csrc/ln_qkv.cu``) on the CPU.

``ops/ln_qkv.py``'s launch sequences (``fwd_sequence``, ``bwd_sequence``)
run through ``PLAIN_LAUNCHER``, the plain version of each C entry: the row
pass (y, the row statistics, the gather G), the head-major q|k|v GEMM, gy,
gw over row ranges summed in order, the LN backward. Held against the plain
versions ``ln_qkv_ref`` / ``ln_qkv_bwd_ref`` and the JAX package's Pallas
kernel (interpret mode, as its own tests run it on the CPU) with its VJP,
on the same numpy draws from a seed. The forward GEMM's epilogue
(``store_plan``: TMA boxes of whole heads, or 16-byte pieces) is checked to
put every element of the product where the head-major layout says.

Bars, those of tests/test_torch_port_ln_qkv.py: in fp32, q, k, v and gx
within 1e-5 absolute, and gw, gs, gb (sums over the whole batch) within
1e-5 of their largest magnitude; in bf16, 2e-2 (q, k, v, gx: absolute and
relative; gw, gs, gb: of their largest magnitude), since both sides round y
and each output once to bf16 after fp32 sums taken in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.ops.ln_qkv_pallas import ln_qkv_fused as jax_ln_qkv
from mirror_tpu_torch.ops import ln_qkv as lq
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

EPS = 1e-5
# (b, n, d, heads, dh): h dh = d; h dh != d with dh 24 (3 h dh = 144, not a
# multiple of the 192-column tile); one head of 40; 200 rows (4 K steps of
# gw's 64 rows)
SHAPES = [(3, 24, 32, 4, 8), (2, 40, 64, 2, 24), (3, 33, 48, 1, 40), (5, 40, 32, 2, 16)]


def _draws(b, n, d, heads, dh, seed=11):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, n, d)).astype(np.float32),
        s=(1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
        b=(0.1 * rng.normal(size=(d,))).astype(np.float32),
        w=(0.05 * rng.normal(size=(d, 3 * heads * dh))).astype(np.float32),
        c=[rng.normal(size=(b, heads, n, dh)).astype(np.float32) for _ in range(3)],
    )


def _torch(draws, dtype=torch.float32):
    x, s, b, w = (torch.from_numpy(draws[k]) for k in "xsbw")
    return x.to(dtype), s, b, w.to(dtype), [torch.from_numpy(c).to(dtype) for c in draws["c"]]


def _jax(draws, heads, dtype=jnp.float32):
    """The Pallas kernel's (q, k, v) and its VJP for cotangents c: (gx, gs,
    gb, gw)."""
    x, s, b, w = (jnp.asarray(draws[k]) for k in "xsbw")
    x, w = x.astype(dtype), w.astype(dtype)
    outs, vjp = jax.vjp(lambda *a: jax_ln_qkv(*a, heads, EPS), x, s, b, w)
    grads = vjp(tuple(jnp.asarray(c, dtype) for c in draws["c"]))
    return outs, grads


def _close(got, want, atol, name):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=name)


def _sum_close(got, want, rel, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("b,n,d,heads,dh", SHAPES)
def test_sequences_match_plain_and_pallas_fp32(b, n, d, heads, dh):
    draws = _draws(b, n, d, heads, dh)
    x, s, lb, w, c = _torch(draws)
    got = lq.fwd_sequence(x, s, lb, w, heads, EPS, ops=lq.PLAIN_LAUNCHER)
    plain = lq.ln_qkv_ref(x, s, lb, w, heads, EPS)
    want, want_grads = _jax(draws, heads)
    for name, o, p, j in zip("qkv", got, plain, want):
        assert o.shape == (b, heads, n, dh), name
        _close(o, p, 1e-5, f"{name} vs plain")
        _close(o, j, 1e-5, f"{name} vs pallas")
    gx, gw, gs, gb = lq.bwd_sequence(x, s, lb, w, *c, heads, EPS, ops=lq.PLAIN_LAUNCHER)
    px, pw, ps, pb = lq.ln_qkv_bwd_ref(x, s, lb, w, *c, heads, EPS)
    jx, js, jb, jw = want_grads
    _close(gx, px, 1e-5, "gx vs plain")
    _close(gx, jx, 1e-5, "gx vs pallas")
    for name, g, p, j in (("gw", gw, pw, jw), ("gs", gs, ps, js), ("gb", gb, pb, jb)):
        _sum_close(g, p, 1e-5, f"{name} vs plain")
        _sum_close(g, j, 1e-5, f"{name} vs pallas")


@pytest.mark.parametrize("b,n,d,heads,dh", SHAPES)
def test_sequences_match_plain_and_pallas_bf16(b, n, d, heads, dh):
    draws = _draws(b, n, d, heads, dh)
    x, s, lb, w, c = _torch(draws, torch.bfloat16)
    got = lq.fwd_sequence(x, s, lb, w, heads, EPS, ops=lq.PLAIN_LAUNCHER)
    plain = lq.ln_qkv_ref(x, s, lb, w, heads, EPS)
    want, want_grads = _jax(draws, heads, jnp.bfloat16)
    for name, o, p, j in zip("qkv", got, plain, want):
        assert o.dtype == torch.bfloat16, name
        assert torch.equal(o, p), f"{name}: the plain launches round as ln_qkv_ref does"
        np.testing.assert_allclose(o.float().numpy(), np.asarray(j, np.float32), rtol=2e-2,
                                   atol=2e-2, err_msg=name)
    gx, gw, gs, gb = lq.bwd_sequence(x, s, lb, w, *c, heads, EPS, ops=lq.PLAIN_LAUNCHER)
    assert (gx.dtype, gw.dtype, gs.dtype, gb.dtype) == (torch.bfloat16, torch.bfloat16,
                                                        torch.float32, torch.float32)
    px, pw, ps, pb = lq.ln_qkv_bwd_ref(x, s, lb, w, *c, heads, EPS)
    jx, js, jb, jw = want_grads
    for ref, what in ((px, "plain"), (jx, "pallas")):
        np.testing.assert_allclose(gx.float().numpy(), np.asarray(ref, np.float32), rtol=2e-2,
                                   atol=2e-2, err_msg=f"gx vs {what}")
    for name, g, p, j in (("gw", gw, pw, jw), ("gs", gs, ps, js), ("gb", gb, pb, jb)):
        _sum_close(g, p, 2e-2, f"{name} vs plain")
        _sum_close(g, j, 2e-2, f"{name} vs pallas")


@pytest.mark.parametrize("b,n,d,heads,dh", SHAPES)
def test_gw_row_splits_agree(b, n, d, heads, dh):
    """gw summed over 1, 2 or one range a sequence's worth of rows (as many
    ranges as sequences) agrees within fp32 rounding; gx, gs and gb do not
    depend on the split."""
    x, s, lb, w, c = _torch(_draws(b, n, d, heads, dh))
    runs = {k: lq.bwd_sequence(x, s, lb, w, *c, heads, EPS, splits=k, ops=lq.PLAIN_LAUNCHER)
            for k in (1, 2, b)}
    for k in (2, b):
        _sum_close(runs[k][1], runs[1][1].numpy(), 1e-5, f"gw, {k} splits")
        for i in (0, 2, 3):
            assert torch.equal(runs[k][i], runs[1][i])


@pytest.mark.parametrize("rows,splits", [(72, 1), (72, 2), (72, 3), (200, 5), (2117, 7),
                                         (135488, 7), (64, 4)])
def test_gw_row_ranges_are_whole_steps(rows, splits):
    ranges = lq.gw_row_ranges(rows, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == rows and 1 <= len(ranges) <= splits
    for (r0, r1), (n0, _) in zip(ranges, ranges[1:]):
        assert r1 == n0 and (r1 - r0) % lq.ROW_STEP == 0
    assert all(r1 > r0 for r0, r1 in ranges)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,heads,dh", SHAPES)
def test_gather_is_the_head_major_split_undone(b, n, d, heads, dh, dtype):
    """The row pass's G, fed ln_qkv_ref's q, k, v, is bit for bit the
    product before the head split, and ln_qkv_bwd_ref's gather."""
    x, s, lb, w, _ = _torch(_draws(b, n, d, heads, dh), dtype)
    q, k, v = lq.ln_qkv_ref(x, s, lb, w, heads, EPS)
    y = torch.empty(b * n, d, dtype=dtype)
    G = torch.empty(b * n, 3 * heads * dh, dtype=dtype)
    lq.rows_ref(x, s, lb, EPS, y, g=(q, k, v), G=G)
    product = (y.float() @ w.float()).to(dtype)
    assert torch.equal(G, product)
    assert torch.equal(G, torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).reshape(b * n, -1))


# (b, n, heads): n past one 128-row tile with a short last one, and a last
# column tile that holds one head of 96 (3 h dh = 288)
@pytest.mark.parametrize("dh,b,n,heads", [(8, 2, 130, 3), (24, 3, 37, 2), (40, 2, 129, 4),
                                          (96, 2, 130, 1), (96, 3, 200, 8), (64, 2, 70, 3),
                                          (192, 1, 129, 1)])
def test_store_plan_places_every_box(dh, b, n, heads):
    """Every element of the [b n, 3 h dh] product lands once, where the
    head-major [3][b h, n, dh] layout puts it; dh 64, 96, 192 go out as
    boxes of at most [64, 64] inside one head and one sequence, other dh as
    16-byte pieces."""
    rng = np.random.default_rng(dh)
    N = 3 * heads * dh
    product = rng.normal(size=(b * n, N)).astype(np.float32)
    out = np.full((3, b * heads, n, dh), np.nan, np.float32)
    count = np.zeros(out.shape, np.int64)
    boxes = dh in (64, 96, 192)
    for row0, rows, col0, cols, which, bh, i0, e0 in lq.store_plan(b, n, heads, dh):
        if boxes:
            assert rows <= 64 and cols <= lq.BOX and e0 % lq.BOX == 0 and i0 % 64 == 0
            assert row0 // n == (row0 + rows - 1) // n == bh // heads  # one sequence
        else:
            assert (rows, cols) == (1, 8)
        assert e0 + cols <= dh and i0 + rows <= n
        out[which, bh, i0:i0 + rows, e0:e0 + cols] = product[row0:row0 + rows, col0:col0 + cols]
        count[which, bh, i0:i0 + rows, e0:e0 + cols] += 1
    want = product.reshape(b, n, 3, heads, dh).transpose(2, 0, 3, 1, 4).reshape(out.shape)
    assert (count == 1).all()
    np.testing.assert_array_equal(out, want)
