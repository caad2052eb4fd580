"""The port's exact pinv backward (TPU kernel 2b's function) against the JAX
package's Pallas VJP, on the CPU.

The JAX side runs ``pinv_pallas._bwd_call`` (and ``jax.grad`` of
``moore_penrose_pinv_pallas(grad="exact")``) in interpret mode, sized as
tests/test_pinv_pallas.py sizes it (b 1, h 2, m 128); the port's side is
``pinv_exact_bwd_ref``, the plain version the CPU takes and the card's
kernel is held against. In fp32 every rounding point of the two is the
identity, so the bar is 1e-5 of the largest magnitude (sums in another
order). The whole gradient, the scale's path through the two max()
reductions included, uses a softmax whose rows are rescaled, so that the
maximal row and column sums are unique: on a plain softmax every row sum
is 1 up to rounding and which row wins the max (and takes the scale's
gradient) depends on the summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.ops import pinv_pallas
from mirror_tpu_torch.ops.pinv import global_scale, moore_penrose_pinv, pinv_exact_bwd_ref
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

REL = 1e-5


def _softmax_like(seed, b=1, h=2, m=128, row_scale=False):
    rng = np.random.default_rng(seed)
    sim = rng.standard_normal((b, h, m, m)).astype(np.float32)
    x = np.exp(sim - sim.max(-1, keepdims=True))
    x /= x.sum(-1, keepdims=True)
    if row_scale:
        x *= rng.uniform(0.5, 1.5, size=(b, h, m, 1))
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x.astype(np.float32), g


def _close(port, ref, rel=REL, name=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), f"{name}: max abs err {err} > {rel} x {np.abs(ref).max()}"


@pytest.mark.parametrize("iters", [6, 2, 0])
def test_exact_bwd_ref_matches_pallas_bwd_call(iters):
    """gx and gs of the plain version against the Pallas backward body."""
    x, g = _softmax_like(0)
    xj = jnp.asarray(x)
    abs_x = jnp.abs(xj)
    s = (jnp.max(abs_x.sum(-1)) * jnp.max(abs_x.sum(-2))).astype(jnp.float32)
    gx_j, gs_j = pinv_pallas._bwd_call(xj, s, jnp.asarray(g), iters)
    xt = torch.from_numpy(x)
    st = global_scale(xt)
    assert float(st) == pytest.approx(float(s), rel=1e-6)
    gx_t, gs_t = pinv_exact_bwd_ref(xt, st, torch.from_numpy(g), iters)
    assert gx_t.dtype == torch.float32 and gs_t.shape == ()
    _close(gx_t.numpy(), gx_j, name="gx")
    assert float(gs_t) == pytest.approx(float(gs_j), rel=REL)


def test_exact_grad_matches_jax_grad_scale_path_included():
    """moore_penrose_pinv(grad="exact") through autograd (PinvExact, its
    scale an input computed outside it) against jax.grad of the Pallas
    entry point, whose scale gradient XLA takes through the max()."""
    x, g = _softmax_like(1, row_scale=True)
    want = jax.grad(lambda x: jnp.sum(
        pinv_pallas.moore_penrose_pinv_pallas(x, 6, grad="exact") * jnp.asarray(g)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    z = moore_penrose_pinv(xt, 6, grad="exact")
    (z * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), want, name="dx")
    # and the bar sees the scale's path: the gradient without it (gx of the
    # backward alone) misses by more than 3x the bar
    gx_no_scale, _ = pinv_exact_bwd_ref(xt.detach(), global_scale(xt.detach()),
                                        torch.from_numpy(g), 6)
    assert np.abs(gx_no_scale.numpy() - np.asarray(want)).max() > 3 * REL * np.abs(
        np.asarray(want)).max()


def test_exact_forward_is_the_iterations():
    x, _ = _softmax_like(2)
    want = pinv_pallas.moore_penrose_pinv_pallas(jnp.asarray(x), 6, grad="exact")
    _close(moore_penrose_pinv(torch.from_numpy(x), 6, grad="exact").numpy(), want,
           rel=1e-4, name="z")


def test_exact_bwd_ref_rounds_like_the_kernel_in_bf16():
    """In bf16 the plain version keeps the Pallas body's rounding points:
    it stays within a few bf16 ulps of the fp32 backward (relative Frobenius
    2e-2, the card's bar for the kernel against it) and returns x's dtype."""
    x, g = _softmax_like(3)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    s = global_scale(xt)
    gx32, gs32 = pinv_exact_bwd_ref(xt, s, gt, 6)
    gx16, gs16 = pinv_exact_bwd_ref(xt.bfloat16(), s, gt.bfloat16(), 6)
    assert gx16.dtype == torch.bfloat16 and gs16.dtype == torch.float32
    rel = ((gx16.float() - gx32).norm() / gx32.norm()).item()
    assert rel <= 2e-2, rel
    assert float(gs16) == pytest.approx(float(gs32), rel=2e-2)


def test_unknown_grad_is_refused():
    with pytest.raises(ValueError, match="exact"):
        moore_penrose_pinv(torch.zeros(1, 1, 8, 8), grad="implict")
