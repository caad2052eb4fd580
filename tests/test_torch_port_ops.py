"""The PyTorch port's plain kernel versions against the JAX package's Pallas
kernels (run in interpret mode on the CPU, as the JAX package's own kernel
tests run them), on the same inputs made with numpy from a seed, in fp32.

Bar: max abs error <= 1e-5, except the pinv, which is held to <= 1e-4 of
the result's largest magnitude: its 6 iterations amplify the rounding-order
differences of the matrix products. The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_port_cuda.py and
chip_smoke.py).
"""

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


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=atol)


# (b, h, n, dh, m): pad = (m - n % m) % m as the Nystrom attention takes it.
# n=20, m=8: pad 4, l 3 -> group 0 is all pad, group 1 straddles;
# n=40, m=8: pad 24, l 8 -> groups 0-2 all pad; n=64, m=16: no pad;
# n=45, m=8: pad 3, l 6 -> group 0 straddles (the slice's 2117/384 kind).
LANDMARK_SHAPES = [(2, 2, 20, 16, 8), (1, 2, 40, 16, 8), (2, 3, 64, 32, 16),
                   (1, 2, 45, 16, 8)]


@pytest.mark.parametrize("b,h,n,dh,m", LANDMARK_SHAPES)
def test_landmark_softmax_matches_pallas(b, h, n, dh, m):
    rng = np.random.default_rng(0)
    q, k = _randn(rng, b, h, n, dh), _randn(rng, b, h, n, dh)
    pad = (m - n % m) % m
    ref = jax_landmark_softmax(jnp.asarray(q), jnp.asarray(k), m, pad)
    out = landmark_softmax(torch.from_numpy(q), torch.from_numpy(k), m, pad)
    for name, o, r in zip(("q_l", "k_l", "attn2"), out, ref):
        assert o.shape == r.shape, name
        _close(o, r)


@pytest.mark.parametrize("b,h,m", [(1, 2, 32), (2, 1, 48)])
def test_pinv_matches_pallas(b, h, m):
    rng = np.random.default_rng(1)
    sim = _randn(rng, b, h, m, m)
    x = np.exp(sim - sim.max(-1, keepdims=True))
    x = (x / x.sum(-1, keepdims=True)).astype(np.float32)  # a softmax matrix
    ref = np.asarray(moore_penrose_pinv_pallas(jnp.asarray(x), 6))
    out = moore_penrose_pinv(torch.from_numpy(x), 6)
    _close(out, ref, atol=1e-4 * np.abs(ref).max())


# (b, h, m, n, dh, pad): r3 = softmax(q_l k^T) v over n + pad columns
@pytest.mark.parametrize("b,h,m,n,dh,pad", [(2, 2, 8, 40, 16, 24), (1, 2, 8, 20, 16, 4),
                                            (2, 1, 16, 64, 32, 0)])
def test_landmark_kv_matches_pallas(b, h, m, n, dh, pad):
    rng = np.random.default_rng(2)
    q_l, k, v = _randn(rng, b, h, m, dh), _randn(rng, b, h, n, dh), _randn(rng, b, h, n, dh)
    ref = jax_landmark_kv(jnp.asarray(q_l), jnp.asarray(k), jnp.asarray(v), pad)
    out = softmax_matmul_landmark_kv(*map(torch.from_numpy, (q_l, k, v)), pad)
    _close(out, ref)


def test_landmark_q_matches_pallas():
    rng = np.random.default_rng(3)
    b, h, n, m, dh = 2, 2, 40, 8, 16
    q, k_l, w = _randn(rng, b, h, n, dh), _randn(rng, b, h, m, dh), _randn(rng, b, h, m, dh)
    ref = jax_landmark_q(jnp.asarray(q), jnp.asarray(k_l), jnp.asarray(w))
    out = softmax_matmul_landmark_q(*map(torch.from_numpy, (q, k_l, w)))
    _close(out, ref)


# n=10 is shorter than the conv's half width (16); n=70 spans several rows
@pytest.mark.parametrize("b,h,n,m,dh", [(2, 3, 70, 16, 32), (1, 2, 10, 8, 16)])
def test_attn_conv_matches_pallas(b, h, n, m, dh):
    rng = np.random.default_rng(4)
    q, v = _randn(rng, b, h, n, dh), _randn(rng, b, h, n, dh)
    k_l, w = _randn(rng, b, h, m, dh), _randn(rng, b, h, m, dh)
    kern = _randn(rng, h, 33, scale=0.1)
    args = (q, k_l, w, v, kern)
    ref = jax_fused_softmax_attn_conv(*map(jnp.asarray, args))
    out = fused_softmax_attn_conv(*map(torch.from_numpy, args))
    _close(out, ref)


@pytest.mark.parametrize("b,H,W,C", [(2, 9, 9, 64), (1, 5, 7, 32)])
def test_ppeg_matches_pallas(b, H, W, C):
    rng = np.random.default_rng(5)
    img = _randn(rng, b, H, W, C)
    kern, bias = _randn(rng, 7, 7, C, scale=0.1), _randn(rng, C, scale=0.1)
    ref = jax_ppeg_fused(jnp.asarray(img), jnp.asarray(kern), jnp.asarray(bias))
    out = ppeg_fused(*map(torch.from_numpy, (img, kern, bias)))
    _close(out, ref)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors every wrapper takes its plain version: no kernel is
    built or counted."""
    from mirror_tpu_torch.ops import _common

    _common.reset_launch_counts()
    q = torch.randn(1, 1, 16, 16)
    landmark_softmax(q, q, 8)
    assert _common.launch_counts() == {}
    assert _common._LIB is None
