"""The attention's forward residuals and the backward built on them, against
the JAX package's Pallas kernels.

The port's softmax attention (kernels 3, 3b, 4 and their backwards 3c, 4b)
keeps the row log-sum-exp and the attention output from the forward, and
its backward takes P = exp(q k^T - lse) and D = rowsum(g o) from them,
where the TPU kernels recompute the softmax statistics and take
D = rowsum(attn * (g w^T)). Here the plain versions of that formulation
(``softmax_attn_fwd_ref``, ``softmax_attn_bwd_lse_ref``, which the autograd
Functions run on CPU tensors) are held against
``nystrom_pallas.fused_softmax_attn`` / ``fused_softmax_attn_conv`` and
their ``jax.vjp``, run in interpret mode on the CPU as the JAX package's
own kernel tests run them. Inputs are made with numpy from a seed.

Bars:
- fp32: max |port - jax| <= 1e-5 of the JAX value's largest magnitude, the
  bar of test_torch_port_ops.py and test_torch_port_grads.py; in fp32
  D = rowsum(g o) equals rowsum(attn * dattn) to rounding, since o = attn w.
  The log-sum-exp against a direct fp32 ``logsumexp`` over [0] * pad + sim:
  max abs error <= 1e-5 of its largest magnitude.
- bf16 (inputs, outputs and the dsim rounding in bf16 on both sides):
  relative Frobenius error <= 1e-2 on the output (one bf16 rounding,
  2^-8 relative, after fp32 sums in another order) and <= 2e-2 on each
  gradient (the backward kernels' bar). Beyond the output's rounding, the
  port's D comes from o, itself rounded to bf16 (2^-8 relative), and P
  inside o was rounded to bf16 too; a dsim value can then round to the
  neighbouring bf16 value, and dq, dk sum such terms with cancellation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.ops.nystrom_pallas import (
    fused_softmax_attn as jax_fused_softmax_attn,
    fused_softmax_attn_conv as jax_fused_softmax_attn_conv,
)
from mirror_tpu_torch.ops.nystrom_attn import (
    fused_softmax_attn,
    fused_softmax_attn_conv,
    softmax_attn_bwd_lse_ref,
    softmax_attn_fwd_ref,
)

REL = 1e-5
BF16_FWD, BF16_BWD = 1e-2, 2e-2

# (b, h, r, c, dh, pad): ragged r and c, pad 0 and > 0, dh 16 and 32
ATTN_SHAPES = [(1, 2, 8, 40, 16, 24), (2, 3, 70, 130, 32, 0), (1, 2, 70, 130, 16, 61),
               (2, 1, 33, 17, 32, 5)]
# (b, h, n, m, dh, pad) of the conv-fused instance: n shorter than the conv's
# half width (16) too
CONV_SHAPES = [(2, 3, 70, 16, 32, 0), (1, 2, 10, 8, 16, 0), (1, 2, 40, 24, 16, 7)]


def _inputs(seed, b, h, r, c, dh, conv):
    rng = np.random.default_rng(seed)
    x = [(dh ** -0.5 * rng.standard_normal((b, h, r, dh))),
         rng.standard_normal((b, h, c, dh)), rng.standard_normal((b, h, c, dh))]
    if conv:
        x += [rng.standard_normal((b, h, r, dh)), 0.1 * rng.standard_normal((h, 33))]
    g = rng.standard_normal((b, h, r, dh))
    return [a.astype(np.float32) for a in x], g.astype(np.float32)


def _jax_fn(conv, pad):
    if conv:
        return lambda q, k, w, v, kern: jax_fused_softmax_attn_conv(q, k, w, v, kern, pad)
    return lambda q, k, w: jax_fused_softmax_attn(q, k, w, pad)


def _port_fn(conv, pad):
    if conv:
        return lambda q, k, w, v, kern: fused_softmax_attn_conv(q, k, w, v, kern, pad)
    return lambda q, k, w: fused_softmax_attn(q, k, w, pad)


def _max_close(name, got, ref, rel=REL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{name}: max abs error {err} > {rel} x {scale}"


def _fro_close(name, got, ref, bound):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    err = float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
    assert err <= bound, f"{name}: relative Frobenius error {err} > {bound}"


@pytest.mark.parametrize("b,h,r,c,dh,pad", ATTN_SHAPES)
def test_forward_out_and_lse(b, h, r, c, dh, pad):
    (q, k, w), _ = _inputs(30, b, h, r, c, dh, False)
    out, lse, o = softmax_attn_fwd_ref(*map(torch.from_numpy, (q, k, w)), pad)
    _max_close("out", out, jax_fused_softmax_attn(*map(jnp.asarray, (q, k, w)), pad))
    assert o is out  # without the conv the output is the backward's o
    sim = torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2)
    direct = torch.logsumexp(torch.cat([sim.new_zeros(b, h, r, pad), sim], dim=-1), dim=-1)
    assert lse.dtype == torch.float32
    _max_close("lse", lse, direct.numpy())


@pytest.mark.parametrize("b,h,n,m,dh,pad", CONV_SHAPES)
def test_forward_conv_out_and_o_attn(b, h, n, m, dh, pad):
    (q, k, w, v, kern), _ = _inputs(31, b, h, n, m, dh, True)
    args = list(map(torch.from_numpy, (q, k, w, v, kern)))
    out, lse, o_attn = softmax_attn_fwd_ref(*args[:3], pad, *args[3:])
    _max_close("out", out,
               jax_fused_softmax_attn_conv(*map(jnp.asarray, (q, k, w, v, kern)), pad))
    # o_attn is the attention part alone: the bare kernel's output
    _max_close("o_attn", o_attn, jax_fused_softmax_attn(*map(jnp.asarray, (q, k, w)), pad))
    sim = args[0] @ args[1].transpose(-1, -2)
    direct = torch.logsumexp(torch.cat([sim.new_zeros(b, h, n, pad), sim], dim=-1), dim=-1)
    _max_close("lse", lse, direct.numpy())


def _check_grads(conv, pad, inputs, g, dtype):
    """The port's autograd Function (whose CPU backward is the plain
    version from the residuals) against jax.vjp, in ``dtype``."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    outs, vjp = jax.vjp(_jax_fn(conv, pad), *[jnp.asarray(x, jdt) for x in inputs])
    ref = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in inputs]
    out = _port_fn(conv, pad)(*leaves)
    out.backward(torch.from_numpy(g).to(dtype))
    names = ("dq", "dk", "dw", "dv", "dkern")[:len(inputs)]
    if dtype == torch.float32:
        _max_close("out", out, outs)
        for name, t, r in zip(names, leaves, ref):
            _max_close(name, t.grad, r)
        return
    _fro_close("out", out, outs.astype(jnp.float32), BF16_FWD)
    for name, t, r in zip(names, leaves, ref):
        assert t.grad.dtype == torch.bfloat16, name
        _fro_close(name, t.grad, r.astype(jnp.float32), BF16_BWD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,r,c,dh,pad", ATTN_SHAPES)
def test_backward_from_residuals_matches_pallas_vjp(b, h, r, c, dh, pad, dtype):
    inputs, g = _inputs(32, b, h, r, c, dh, False)
    _check_grads(False, pad, inputs, g, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,n,m,dh,pad", CONV_SHAPES)
def test_conv_backward_from_residuals_matches_pallas_vjp(b, h, n, m, dh, pad, dtype):
    inputs, g = _inputs(33, b, h, n, m, dh, True)
    _check_grads(True, pad, inputs, g, dtype)


def test_backward_plain_version_takes_d_from_o():
    """softmax_attn_bwd_lse_ref takes D from o alone: with o zeroed the D
    term drops out of dsim = P dattn - P D, so dq moves by exactly (P D) k,
    and dw = bf16(P)^T g, which needs no D, does not move."""
    (q, k, w), g = _inputs(34, 1, 2, 8, 40, 16, False)
    q, k, w, g = map(torch.from_numpy, (q, k, w, g))
    _, lse, o = softmax_attn_fwd_ref(q, k, w, 24)
    dq, _, dw = softmax_attn_bwd_lse_ref(q, k, w, g, lse, o)
    dq0, _, dw0 = softmax_attn_bwd_lse_ref(q, k, w, g, lse, torch.zeros_like(o))
    p = torch.exp(q @ k.transpose(-1, -2) - lse.unsqueeze(-1))
    d = (g * o).sum(-1, keepdim=True)
    torch.testing.assert_close(dq0 - dq, (p * d) @ k, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dw0, dw)  # dw = bf16(P)^T g needs no D


def test_residuals_kept_only_for_autograd():
    """The Function saves lse and o only when autograd records the call."""
    (q, k, w, v, kern), _ = _inputs(35, 1, 2, 10, 8, 16, True)
    q, k, w, v, kern = map(torch.from_numpy, (q, k, w, v, kern))
    with torch.no_grad():
        assert fused_softmax_attn(q.requires_grad_(), k, w).grad_fn is None
    out = fused_softmax_attn(q, k, w)
    assert len(out.grad_fn.saved_tensors) == 5  # q, k, w, lse, the output
    out = fused_softmax_attn_conv(q, k, w, v, kern)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7 and saved[5].shape == (1, 2, 10)  # ..., lse, o_attn
    assert fused_softmax_attn(q.detach(), k, w).grad_fn is None
