"""The port's backward passes against the JAX package's custom VJPs.

Each autograd Function of ``mirror_tpu_torch.ops`` runs here on CPU
tensors, so its backward is the plain version of the CUDA kernel; the JAX
side is ``jax.vjp`` of the Pallas entry point, run in interpret mode on the
CPU as the JAX package's own kernel tests run it. Same inputs and incoming
gradients, made with numpy from a seed, in fp32.

Bar: max |port - jax| <= 1e-5 of the JAX gradient's largest magnitude,
except where an output is rounded to bf16 by design (the PPEG bias
gradient in a bf16 bias's dtype: both sides round the same fp32 sum, and a
one-ulp fp32 difference may round to the neighbouring bf16 value, 2^-8
relative).
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

REL = 1e-5


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _port_vjp(fn, inputs, cotangents):
    """Outputs and input gradients of the port's fn for the cotangents."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    return outs, [t.grad for t in leaves]


def _jax_vjp(fn, inputs, cotangents):
    outs, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
    cts = tuple(map(jnp.asarray, cotangents))
    return outs, vjp(cts if isinstance(outs, tuple) else cts[0])


def _close(name, port, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy()
    assert port.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"{name}: max abs error {err} > {rel} x {scale}"


# (b, h, n, dh, m), pad = (m - n % m) % m: n=20, m=8: pad 4, l 3, group 0 all
# pad; n=40, m=8: pad 24, l 8, groups 0-2 all pad; n=64, m=16: no pad;
# n=45, m=8: pad 3, l 6, group 0 straddles (the slice's 2117/384 kind)
@pytest.mark.parametrize("b,h,n,dh,m", [(2, 2, 20, 16, 8), (1, 2, 40, 16, 8),
                                        (2, 2, 64, 16, 16), (1, 2, 45, 16, 8)])
def test_landmark_softmax_grad_matches_pallas_vjp(b, h, n, dh, m):
    rng = np.random.default_rng(20)
    q, k = _randn(rng, b, h, n, dh, scale=dh ** -0.5), _randn(rng, b, h, n, dh)
    pad = (m - n % m) % m
    cts = [_randn(rng, b, h, m, dh), _randn(rng, b, h, m, dh), _randn(rng, b, h, m, m)]
    _, ref = _jax_vjp(lambda q, k: jax_landmark_softmax(q, k, m, pad), (q, k), cts)
    _, got = _port_vjp(lambda q, k: landmark_softmax(q, k, m, pad), (q, k), cts)
    for name, g, r in zip(("dq", "dk"), got, ref):
        _close(name, g, r)


@pytest.mark.parametrize("b,h,m,n,dh,pad", [(2, 2, 8, 40, 16, 24), (1, 2, 8, 20, 16, 4),
                                            (2, 1, 16, 64, 32, 0)])
def test_landmark_kv_grad_matches_pallas_vjp(b, h, m, n, dh, pad):
    """Kernel 3c: the softmax over n + pad columns, in the kv variant."""
    rng = np.random.default_rng(21)
    ins = (_randn(rng, b, h, m, dh), _randn(rng, b, h, n, dh), _randn(rng, b, h, n, dh))
    cts = [_randn(rng, b, h, m, dh)]
    _, ref = _jax_vjp(lambda q, k, v: jax_landmark_kv(q, k, v, pad), ins, cts)
    _, got = _port_vjp(lambda q, k, v: softmax_matmul_landmark_kv(q, k, v, pad), ins, cts)
    for name, g, r in zip(("dq_l", "dk", "dv"), got, ref):
        _close(name, g, r)


def test_landmark_q_grad_matches_pallas_vjp():
    rng = np.random.default_rng(22)
    b, h, n, m, dh = 2, 2, 40, 8, 16
    ins = (_randn(rng, b, h, n, dh), _randn(rng, b, h, m, dh), _randn(rng, b, h, m, dh))
    cts = [_randn(rng, b, h, n, dh)]
    _, ref = _jax_vjp(jax_landmark_q, ins, cts)
    _, got = _port_vjp(softmax_matmul_landmark_q, ins, cts)
    for name, g, r in zip(("dq", "dk_l", "dw"), got, ref):
        _close(name, g, r)


# kernel 4b; n=10 is shorter than the conv's half width (16)
@pytest.mark.parametrize("b,h,n,m,dh", [(2, 3, 70, 16, 32), (1, 2, 10, 8, 16)])
def test_attn_conv_grad_matches_pallas_vjp(b, h, n, m, dh):
    rng = np.random.default_rng(23)
    ins = (_randn(rng, b, h, n, dh, scale=dh ** -0.5), _randn(rng, b, h, m, dh),
           _randn(rng, b, h, m, dh), _randn(rng, b, h, n, dh), _randn(rng, h, 33, scale=0.1))
    cts = [_randn(rng, b, h, n, dh)]
    _, ref = _jax_vjp(jax_fused_softmax_attn_conv, ins, cts)
    _, got = _port_vjp(fused_softmax_attn_conv, ins, cts)
    for name, g, r in zip(("dq", "dk_l", "dw", "dv", "dkern"), got, ref):
        _close(name, g, r)


@pytest.mark.parametrize("b,H,W,C", [(2, 9, 9, 64), (1, 5, 7, 32)])
def test_ppeg_grad_matches_pallas_vjp(b, H, W, C):
    rng = np.random.default_rng(24)
    ins = (_randn(rng, b, H, W, C), _randn(rng, 7, 7, C, scale=0.1), _randn(rng, C, scale=0.1))
    cts = [_randn(rng, b, H, W, C)]
    _, ref = _jax_vjp(jax_ppeg_fused, ins, cts)
    _, got = _port_vjp(ppeg_fused, ins, cts)
    for name, g, r in zip(("dimg", "dk", "db"), got, ref):
        _close(name, g, r)


def test_ppeg_bias_grad_takes_the_bias_dtype():
    """A bf16 bias beside fp32 taps: db comes back in the bias's dtype and dk
    in the taps', on both sides (ppeg_pallas.py:163-173)."""
    rng = np.random.default_rng(25)
    img, kern = _randn(rng, 1, 6, 6, 32), _randn(rng, 7, 7, 32, scale=0.1)
    bias = _randn(rng, 32, scale=0.1)
    g = _randn(rng, 1, 6, 6, 32)
    ref_fn = lambda i, k, b: jax_ppeg_fused(i, k, b.astype(jnp.bfloat16))  # noqa: E731
    _, ref = _jax_vjp(ref_fn, (img, kern, bias), [g])
    t = [torch.from_numpy(img).requires_grad_(), torch.from_numpy(kern).requires_grad_(),
         torch.from_numpy(bias).to(torch.bfloat16).requires_grad_()]
    ppeg_fused(*t).backward(torch.from_numpy(g))
    assert t[1].grad.dtype == torch.float32 and t[2].grad.dtype == torch.bfloat16
    _close("dimg", t[0].grad, ref[0])
    _close("dk", t[1].grad, ref[1])
    # db: a bf16 rounding of the same fp32 sum on both sides (one ulp apart at most)
    _close("db", t[2].grad, np.asarray(ref[2], np.float32), rel=2 ** -8)


@pytest.mark.parametrize("b,h,m", [(1, 2, 32), (2, 1, 48)])
def test_pinv_implicit_grad_matches_pallas_vjp(b, h, m):
    rng = np.random.default_rng(26)
    sim = _randn(rng, b, h, m, m)
    x = np.exp(sim - sim.max(-1, keepdims=True))
    x = (x / x.sum(-1, keepdims=True)).astype(np.float32)
    cts = [_randn(rng, b, h, m, m)]
    _, ref = _jax_vjp(lambda x: moore_penrose_pinv_pallas(x, 6, grad="implicit"), (x,), cts)
    _, got = _port_vjp(lambda x: moore_penrose_pinv(x, 6, grad="implicit"), (x,), cts)
    # the pinv's 6 iterations amplify rounding-order differences of z (the
    # forward's own bar in test_torch_port_ops is 1e-4 relative), and the
    # gradient is a product of two z's
    _close("dx", got[0], ref[0], rel=3e-4)
