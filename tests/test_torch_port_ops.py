"""The PyTorch port's plain kernel versions against the JAX package's Pallas
kernels (run in interpret mode on the CPU, as the JAX package's own kernel
tests run them), on the same inputs made with numpy from a seed, forward and
backward, in float32 and float16: the compute types of ``--no-amp`` and
``--amp-dtype float16``, in which the JAX package runs these kernels and the
port's CUDA instances run since they take those types.

Bars:
- fp32: max abs error <= 1e-5 on the forward, except the pinv, which is held
  to <= 1e-4 of the result's largest magnitude (its 6 iterations amplify
  the rounding-order differences of the matrix products); <= 1e-5 of the
  JAX value's largest magnitude on each gradient, the bar of
  test_torch_port_attn_stats.py (the exact pinv gradient, 2b, <= 1e-4 of
  it, for the forward's reason).
- fp16: max abs error <= 4e-3 of the JAX value's largest magnitude, forward
  and backward. fp16's ulp is 2^-10 = 9.8e-4 relative, both sides round
  their outputs (and P, the landmark means, dsim and the pinv's iterates)
  to fp16 at the same points, and the two frameworks sum in different
  orders, so a value can land one or two fp16 ulps from the other's.
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_port_cuda.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.ops.landmark_pallas import landmark_softmax as jax_landmark_softmax
from mirror_tpu.ops.nystrom_pallas import (
    fused_softmax_attn_conv as jax_fused_softmax_attn_conv,
    softmax_matmul_landmark_kv as jax_landmark_kv,
    softmax_matmul_landmark_q as jax_landmark_q,
)
from mirror_tpu.ops.pinv_pallas import moore_penrose_pinv_pallas
from mirror_tpu.ops.ppeg_pallas import ppeg_fused as jax_ppeg_fused
from mirror_tpu_torch.ops import (
    fused_softmax_attn_conv,
    landmark_softmax,
    moore_penrose_pinv,
    ppeg_fused,
    softmax_matmul_landmark_kv,
    softmax_matmul_landmark_q,
)
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

ATOL = 1e-5
FP16_BAR = 4e-3
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
JAX_DTYPE = {torch.float32: jnp.float32, torch.float16: jnp.float16}


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), rtol=0,
                               atol=atol)


def _close_rel(name, port, ref, bar):
    ref = np.asarray(ref, np.float32)
    err = np.abs(port.detach().float().numpy() - ref).max()
    bound = bar * max(np.abs(ref).max(), 1e-30)
    assert err <= bound, f"{name}: max abs error {err} > {bound}"


def _check(fn_port, fn_jax, inputs, dtype, names, fwd_atol=ATOL, grad_bar=ATOL):
    """fn_port on torch tensors of ``dtype`` (through autograd: the plain
    backward on the CPU) against fn_jax on jax arrays of the same type and
    its jax.vjp, for cotangents drawn from a seed."""
    jdt = JAX_DTYPE[dtype]
    jx = [jnp.asarray(x, jdt) for x in inputs]
    ref, vjp = jax.vjp(fn_jax, *jx)
    refs = ref if isinstance(ref, tuple) else (ref,)
    rng = np.random.default_rng(99)
    cots = [_randn(rng, *r.shape) for r in refs]
    grads_ref = vjp(tuple(jnp.asarray(c, jdt) for c in cots) if isinstance(ref, tuple)
                    else jnp.asarray(cots[0], jdt))
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in inputs]
    out = fn_port(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    for o, r in zip(outs, refs, strict=True):
        assert o.shape == r.shape and o.dtype == dtype
        if dtype == torch.float32:
            _close(o.detach(), r, atol=fwd_atol)
        else:
            _close_rel("out", o, r, FP16_BAR)
    torch.autograd.backward(outs, [torch.from_numpy(c).to(dtype) for c in cots])
    for name, t, r in zip(names, leaves, grads_ref, strict=True):
        assert t.grad.dtype == dtype, name
        _close_rel(name, t.grad, r, grad_bar if dtype == torch.float32 else FP16_BAR)


# (b, h, n, dh, m): pad = (m - n % m) % m as the Nystrom attention takes it.
# n=20, m=8: pad 4, l 3 -> group 0 is all pad, group 1 straddles;
# n=40, m=8: pad 24, l 8 -> groups 0-2 all pad; n=64, m=16: no pad;
# n=45, m=8: pad 3, l 6 -> group 0 straddles (the slice's 2117/384 kind).
LANDMARK_SHAPES = [(2, 2, 20, 16, 8), (1, 2, 40, 16, 8), (2, 3, 64, 32, 16),
                   (1, 2, 45, 16, 8)]


@DTYPES
@pytest.mark.parametrize("b,h,n,dh,m", LANDMARK_SHAPES)
def test_landmark_softmax_matches_pallas(b, h, n, dh, m, dtype):
    rng = np.random.default_rng(0)
    q, k = _randn(rng, b, h, n, dh), _randn(rng, b, h, n, dh)
    pad = (m - n % m) % m
    _check(lambda q, k: landmark_softmax(q, k, m, pad),
           lambda q, k: jax_landmark_softmax(q, k, m, pad), (q, k), dtype, ("dq", "dk"))


@DTYPES
@pytest.mark.parametrize("b,h,m", [(1, 2, 32), (2, 1, 48)])
def test_pinv_matches_pallas(b, h, m, dtype):
    """Kernel 2 and, through the exact gradient, 2b. The softmax's rows
    are rescaled so that the maximal row and column sums are unique: on a
    plain softmax every row sum is 1 up to rounding, and which row takes the
    scale's gradient depends on the summation order
    (test_torch_port_pinv_exact.py)."""
    rng = np.random.default_rng(1)
    sim = _randn(rng, b, h, m, m)
    x = np.exp(sim - sim.max(-1, keepdims=True))
    x = x / x.sum(-1, keepdims=True) * rng.uniform(0.5, 1.5, size=(b, h, m, 1))
    x = x.astype(np.float32)  # a softmax matrix, rows rescaled
    ref = np.asarray(moore_penrose_pinv_pallas(jnp.asarray(x), 6), np.float32)
    _check(lambda x: moore_penrose_pinv(x, 6, grad="exact"),
           lambda x: moore_penrose_pinv_pallas(x, 6, grad="exact"), (x,), dtype, ("dx",),
           fwd_atol=1e-4 * np.abs(ref).max(), grad_bar=1e-4)


# (b, h, m, n, dh, pad): r3 = softmax(q_l k^T) v over n + pad columns
@DTYPES
@pytest.mark.parametrize("b,h,m,n,dh,pad", [(2, 2, 8, 40, 16, 24), (1, 2, 8, 20, 16, 4),
                                            (2, 1, 16, 64, 32, 0)])
def test_landmark_kv_matches_pallas(b, h, m, n, dh, pad, dtype):
    rng = np.random.default_rng(2)
    q_l, k, v = _randn(rng, b, h, m, dh), _randn(rng, b, h, n, dh), _randn(rng, b, h, n, dh)
    _check(lambda *a: softmax_matmul_landmark_kv(*a, pad),
           lambda *a: jax_landmark_kv(*a, pad), (q_l, k, v), dtype, ("dq_l", "dk", "dv"))


@DTYPES
def test_landmark_q_matches_pallas(dtype):
    rng = np.random.default_rng(3)
    b, h, n, m, dh = 2, 2, 40, 8, 16
    q, k_l, w = _randn(rng, b, h, n, dh), _randn(rng, b, h, m, dh), _randn(rng, b, h, m, dh)
    _check(softmax_matmul_landmark_q, jax_landmark_q, (q, k_l, w), dtype, ("dq", "dk_l", "dw"))


# n=10 is shorter than the conv's half width (16); n=70 spans several rows
@DTYPES
@pytest.mark.parametrize("b,h,n,m,dh", [(2, 3, 70, 16, 32), (1, 2, 10, 8, 16)])
def test_attn_conv_matches_pallas(b, h, n, m, dh, dtype):
    rng = np.random.default_rng(4)
    q, v = _randn(rng, b, h, n, dh), _randn(rng, b, h, n, dh)
    k_l, w = _randn(rng, b, h, m, dh), _randn(rng, b, h, m, dh)
    kern = _randn(rng, h, 33, scale=0.1)
    _check(fused_softmax_attn_conv, jax_fused_softmax_attn_conv, (q, k_l, w, v, kern), dtype,
           ("dq", "dk_l", "dw", "dv", "dkern"))


@DTYPES
@pytest.mark.parametrize("b,H,W,C", [(2, 9, 9, 64), (1, 5, 7, 32)])
def test_ppeg_matches_pallas(b, H, W, C, dtype):
    rng = np.random.default_rng(5)
    img = _randn(rng, b, H, W, C)
    kern, bias = _randn(rng, 7, 7, C, scale=0.1), _randn(rng, C, scale=0.1)
    _check(ppeg_fused, jax_ppeg_fused, (img, kern, bias), dtype, ("dimg", "dk", "db"))


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors every wrapper takes its plain version: no kernel is
    built or counted."""
    from mirror_tpu_torch.ops import _common

    _common.reset_launch_counts()
    q = torch.randn(1, 1, 16, 16)
    landmark_softmax(q, q, 8)
    assert _common.launch_counts() == {}
    assert _common._LIB is None
