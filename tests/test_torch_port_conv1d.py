"""The port's ``depthwise_conv1d_seq`` (kernel 9; its plain version on the
CPU) against the JAX package's Pallas kernel in interpret mode: the value
and both gradients, at the JAX tests' shapes (tests/test_conv1d_pallas.py),
on the same inputs made with numpy from a seed.

Bars: in fp32, the value and dv within 1e-5 absolute (the suite's bar);
dkern, a sum over batch, rows and features, within 1e-5 of its largest
magnitude. With bf16 v and fp32 taps (``bench.py --selftest``'s types) both
sides round the taps to bf16 and take an fp32 sum rounded once to bf16, so
the value and dv agree within one bf16 step (2^-7 relative); dkern is fp32,
the taps' dtype, at 1e-5 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.ops.conv1d_pallas import depthwise_conv1d_seq as jax_conv
from mirror_tpu_torch.ops.conv1d import depthwise_conv1d_seq
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

BF16_STEP = 2.0 ** -7


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
    return out, dv, dk


def _port(v, kern, t, v_dtype):
    vt = torch.from_numpy(v).to(v_dtype).requires_grad_()
    kt = torch.from_numpy(kern).requires_grad_()
    out = depthwise_conv1d_seq(vt, kt)
    (out.float() * torch.from_numpy(t)).sum().backward()
    return out, vt.grad, kt.grad


def _f32(a):
    return np.asarray(a, dtype=np.float32) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


@pytest.mark.parametrize("b,h,n,d,ksize", [
    (2, 3, 500, 32, 33),   # test_conv1d_value_parity
    (2, 3, 384, 16, 7),    # an exact multiple of the TPU row tile
    (2, 3, 200, 16, 9),    # test_conv1d_grad_parity
    (8, 2, 416, 16, 33),   # the batch-grouped program, a short last tile
    (2, 3, 10, 16, 33),    # n <= K // 2: taps with no overlap add nothing
])
def test_conv1d_matches_jax_fp32(b, h, n, d, ksize):
    v, kern, t = _draws(b * 1000 + n, b, h, n, d, ksize)
    want = _jax(v, kern, t, jnp.float32)
    got = _port(v, kern, t, torch.float32)
    for name, g, w in zip(("out", "dv"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(_f32(g), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)
    dk, dk_want = _f32(got[2]), np.asarray(want[2])
    assert got[2].shape == (h, ksize)
    np.testing.assert_allclose(dk, dk_want, rtol=0, atol=1e-5 * np.abs(dk_want).max())


def test_conv1d_bf16_values_fp32_taps_match_jax():
    """bench.py --selftest's types, small: bf16 v, fp32 taps. The gradient
    of the taps takes their dtype, dv v's."""
    v, kern, t = _draws(5, 2, 3, 130, 16, 33)
    want = _jax(v, kern, t, jnp.bfloat16)
    got = _port(v, kern, t, torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    assert [w.dtype for w in want] == [jnp.bfloat16, jnp.bfloat16, jnp.float32]
    for name, g, w in zip(("out", "dv"), got, want):
        w = _f32(w)
        np.testing.assert_allclose(_f32(g), w, rtol=BF16_STEP, atol=1e-6, err_msg=name)
    dk_want = np.asarray(want[2])
    np.testing.assert_allclose(_f32(got[2]), dk_want, rtol=0,
                               atol=1e-5 * np.abs(dk_want).max())
