"""The port's ``ln_qkv_fused`` (kernel 10; its plain version on the CPU)
against the JAX package's Pallas kernel in interpret mode, on the same
inputs made with numpy from a seed (the JAX tests' draws,
tests/test_ln_qkv_pallas.py).

Bars: in fp32, q, k, v and gx within 1e-5 absolute (the suite's bar); gw,
gs and gb, sums over the whole batch, within 1e-5 of their largest
magnitude. In bf16 the outputs within 2e-2 of JAX's (the JAX test's bar for
its bf16 path): both round y and each output once to bf16 after fp32 sums
taken in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.ops.ln_qkv_pallas import ln_qkv_fused as jax_ln_qkv
from mirror_tpu_torch.ops.ln_qkv import ln_qkv_fused
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

B, N, D, EPS = 3, 24, 32, 1e-5
# (heads, dh): inner width h dh = d, and h dh != d (dh is w's, not d / h)
HEAD_SHAPES = [(4, 8), (4, 12)]


def _draws(heads, dh, seed=7):
    rng = np.random.default_rng(seed)
    inner = heads * dh
    return dict(
        x=rng.normal(size=(B, N, D)).astype(np.float32),
        s=(1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32),
        b=(0.1 * rng.normal(size=(D,))).astype(np.float32),
        w=(0.05 * rng.normal(size=(D, 3 * inner))).astype(np.float32),
        c=[rng.normal(size=(B, heads, N, dh)).astype(np.float32) for _ in range(3)],
    )


def _jax_grads(d, heads):
    def loss(x, s, b, w):
        return sum(jnp.sum(o * c) for o, c in zip(jax_ln_qkv(x, s, b, w, heads, EPS), d["c"]))

    args = [jnp.asarray(d[k]) for k in "xsbw"]
    return jax_ln_qkv(*args, heads, EPS), jax.grad(loss, argnums=(0, 1, 2, 3))(*args)


def _port_grads(d, heads, x=None):
    x, s, b, w = (torch.from_numpy(d[k]).requires_grad_() for k in "xsbw")
    outs = ln_qkv_fused(x, s, b, w, heads, EPS)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, d["c"])).backward()
    return outs, (x.grad, s.grad, b.grad, w.grad)


def _assert_sum_close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("heads,dh", HEAD_SHAPES)
def test_ln_qkv_matches_jax_fp32(heads, dh):
    d = _draws(heads, dh)
    want_out, want_grads = _jax_grads(d, heads)
    got_out, got_grads = _port_grads(d, heads)
    for name, g, w in zip("qkv", got_out, want_out):
        assert g.shape == (B, heads, N, dh), name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=name)
    gx, gs, gb, gw = got_grads
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_grads[0]), rtol=0, atol=1e-5)
    for name, g, w in (("gs", gs, want_grads[1]), ("gb", gb, want_grads[2]),
                       ("gw", gw, want_grads[3])):
        _assert_sum_close(g, w, name)


@pytest.mark.parametrize("heads,dh", HEAD_SHAPES)
def test_ln_qkv_bf16_forward_and_dtypes(heads, dh):
    d = _draws(heads, dh)
    xb = torch.from_numpy(d["x"]).to(torch.bfloat16).requires_grad_()
    wb = torch.from_numpy(d["w"]).to(torch.bfloat16).requires_grad_()
    s, b = (torch.from_numpy(d[k]).requires_grad_() for k in "sb")
    got = ln_qkv_fused(xb, s, b, wb, heads, EPS)
    want = jax_ln_qkv(jnp.asarray(d["x"], jnp.bfloat16), jnp.asarray(d["s"]),
                      jnp.asarray(d["b"]), jnp.asarray(d["w"], jnp.bfloat16), heads, EPS)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().detach().numpy(), np.asarray(w, np.float32),
                                   rtol=0.02, atol=0.02)
    sum(o.float().square().sum() for o in got).backward()
    assert (xb.grad.dtype, wb.grad.dtype) == (torch.bfloat16, torch.bfloat16)
    assert (s.grad.dtype, b.grad.dtype) == (torch.float32, torch.float32)


def test_ln_qkv_batch_accumulation_matches_full_batch():
    """gw, gs and gb sum over the batch: per-element calls add up to the
    whole batch's."""
    heads, dh = HEAD_SHAPES[0]
    d = _draws(heads, dh)

    def grads(x):
        xt = torch.from_numpy(x)
        s, b, w = (torch.from_numpy(d[k]).requires_grad_() for k in "sbw")
        sum(o.square().sum() for o in ln_qkv_fused(xt, s, b, w, heads, EPS)).backward()
        return s.grad, b.grad, w.grad

    full = grads(d["x"])
    parts = [grads(d["x"][i:i + 1]) for i in range(B)]
    for j, name in enumerate(("gs", "gb", "gw")):
        _assert_sum_close(sum(p[j] for p in parts), full[j].numpy(), name)
