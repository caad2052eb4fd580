"""Kernels 6 and 7 (``csrc/vit_gemm.cu`` and ``csrc/vit_attn.cu``) as launch
sequences on the CPU, through plain versions of their C entries, held
against the port's plain half-blocks and the JAX package's Pallas kernels.

On the card ``ops/vit_attn.py`` runs a half-block as launches of the LN pass
(``mirror_vit_ln``), the projection GEMM (``mirror_vit_gemm``) in its three
epilogues and, for kernel 6, the attention (``mirror_vit_attn``) on the
q|k|v buffer. Here the same sequences (``attn_block_sequence``,
``mlp_block_sequence``) take ``PLAIN_LAUNCHER``, the plain versions of
those entries, as their launcher parameter, so the order of the launches,
their buffers, layouts and rounding points are checked without a card. The
model keeps its kernel-layout weights across calls: features after
``load_state_dict`` must come from the new weights. Inputs are made from
numpy seeds.

Tolerances, with their reasons:
- the LN pass's plain version against ``_ln_ref``: bit for bit (it is the
  same function, written into the output buffer);
- ``gemm_ref`` against a float64 product with a float64 epilogue: bf16
  outputs within 2^-7 of the largest magnitude (one bf16 ulp is 2^-8
  relative, and the fp32 sum of K products rounds on its own);
- the sequences against ``attn_block_ref`` and ``mlp_block_ref`` in bf16:
  bit for bit (the same products and the same rounding points; q|k|v as one
  [d, 3d] product gives each column the same sum as three [d, d] ones);
- against the Pallas kernels in interpret mode, in fp32 (every rounding
  point is then the identity): the bars tests/test_torch_port_featgen.py
  holds the half-blocks to, 2e-5 (attn_block) and 1e-4 (mlp_block: the TPU
  kernel's Abramowitz-Stegun erf against the port's exact erf, amplified
  by the fc2 contraction);
- the ViT model after ``load_state_dict``: equal to a model built with the
  new weights, bit for bit (the same plain path on the same weights).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.ops.vit_attn_pallas import attn_block as jax_attn_block
from mirror_tpu.ops.vit_attn_pallas import mlp_block as jax_mlp_block
from mirror_tpu_torch.models.feature_extractors import ViTB16, init_weights
from mirror_tpu_torch.ops.vit_attn import (
    PLAIN_LAUNCHER,
    _EPI_BIAS,
    _EPI_BIAS_GELU,
    _EPI_BIAS_RESIDUAL,
    _ln_ref,
    attn_block_qkv,
    attn_block_ref,
    attn_block_sequence,
    gemm_ref,
    ln_ref,
    mlp_block_ref,
    mlp_block_sequence,
)

BOUND_GEMM = 2.0 ** -7
BOUND_PALLAS_ATTN, BOUND_PALLAS_MLP = 2e-5, 1e-4
EPS = 1e-6  # non-default, as in tests/test_vit_sublayer_kernels.py


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _attn_args(rng, b, n, heads, dh, dtype):
    d = heads * dh
    x = _t(_np(rng, b, n, d), dtype)
    ln_s, ln_b = _t(1.0 + _np(rng, 1, d, scale=0.1)), _t(_np(rng, 1, d, scale=0.1))
    wq, wk, wv, wo = (_t(_np(rng, d, d, scale=d ** -0.5), dtype) for _ in range(4))
    bqkv, bo = _t(_np(rng, 1, 3 * d, scale=0.1)), _t(_np(rng, 1, d, scale=0.1))
    return x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo


def _mlp_args(rng, b, n, d, m, dtype):
    x = _t(_np(rng, b, n, d), dtype)
    ln_s, ln_b = _t(1.0 + _np(rng, 1, d, scale=0.1)), _t(_np(rng, 1, d, scale=0.1))
    w1, b1 = _t(_np(rng, d, m, scale=d ** -0.5), dtype), _t(_np(rng, 1, m))
    w2, b2 = _t(_np(rng, m, d, scale=m ** -0.5), dtype), _t(_np(rng, 1, d, scale=0.1))
    return x, ln_s, ln_b, w1, b1, w2, b2


def _attn_sequence(x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo, heads, eps):
    wqkv = torch.cat((wq, wk, wv), dim=1)
    return attn_block_sequence(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, eps,
                               ops=PLAIN_LAUNCHER)


# ---------------------------------------------------------------------------
# one launch: the plain versions keep the C entries' contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d", [(7, 64), (37, 200), (3, 768)])
def test_ln_ref_is_ln_f32(rows, d):
    rng = np.random.default_rng(rows)
    x = _t(_np(rng, rows, d) + 0.5, torch.bfloat16)
    s, b = _t(1.0 + _np(rng, d, scale=0.1)), _t(_np(rng, d, scale=0.1))
    y = torch.full_like(x, float("nan"))
    ln_ref(x, s, b, EPS, y)
    assert torch.equal(y, _ln_ref(x, s, b, EPS))


@pytest.mark.parametrize("epilogue", [_EPI_BIAS, _EPI_BIAS_GELU, _EPI_BIAS_RESIDUAL])
@pytest.mark.parametrize("m,k,n", [(111, 64, 192), (37, 200, 64), (5, 96, 264)])
def test_gemm_ref_contract(epilogue, m, k, n):
    """epilogue(a w + bias) on a ragged [m, k] x [k, n] (B not symmetric),
    rounded once, against a float64 product with the float64 epilogue."""
    rng = np.random.default_rng(m * n + epilogue)
    a = _t(_np(rng, 1, m, k), torch.bfloat16)
    w = _t(_np(rng, k, n, scale=k ** -0.5) + np.linspace(0, 0.1, n, dtype=np.float32),
           torch.bfloat16)
    bias, resid = _t(_np(rng, n)), _t(_np(rng, 1, m, n), torch.bfloat16)
    out = torch.full((1, m, n), float("nan"), dtype=torch.bfloat16)
    gemm_ref(a, w, bias, out, epilogue, resid=resid)
    ref = a.double().reshape(m, k) @ w.double() + bias.double()
    if epilogue == _EPI_BIAS_GELU:
        ref = 0.5 * ref * (1.0 + torch.erf(ref * 2.0 ** -0.5))
    if epilogue == _EPI_BIAS_RESIDUAL:
        ref = resid.double().reshape(m, n) + ref
    err = (out.double().reshape(m, n) - ref).abs().max().item()
    assert err <= BOUND_GEMM * ref.abs().max().item(), err


# ---------------------------------------------------------------------------
# the sequences: bit for bit the plain half-blocks in bf16
# ---------------------------------------------------------------------------

ATTN_SHAPES = [(2, 29, 4, 8), (3, 37, 4, 16), (1, 197, 12, 64)]
MLP_SHAPES = [(3, 23, 32, 128), (2, 37, 64, 256), (1, 197, 768, 3072)]


@pytest.mark.parametrize("b,n,heads,dh", ATTN_SHAPES)
def test_attn_block_sequence_is_attn_block_ref(b, n, heads, dh):
    args = _attn_args(np.random.default_rng(b * n), b, n, heads, dh, torch.bfloat16)
    got = _attn_sequence(*args, heads, EPS)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, attn_block_ref(*args, heads, EPS))


@pytest.mark.parametrize("b,n,d,m", MLP_SHAPES)
def test_mlp_block_sequence_is_mlp_block_ref(b, n, d, m):
    args = _mlp_args(np.random.default_rng(b * n + d), b, n, d, m, torch.bfloat16)
    got = mlp_block_sequence(*args, EPS, ops=PLAIN_LAUNCHER)
    assert torch.equal(got, mlp_block_ref(*args, EPS))


def test_attn_block_qkv_on_the_cpu_is_attn_block():
    """The model's entry (W_q | W_k | W_v side by side) on CPU tensors is the
    plain half-block."""
    args = _attn_args(np.random.default_rng(5), 2, 17, 4, 8, torch.bfloat16)
    x, ln_s, ln_b, wq, wk, wv, bqkv, wo, bo = args
    got = attn_block_qkv(x, ln_s, ln_b, torch.cat((wq, wk, wv), 1), bqkv, wo, bo, 4, EPS)
    assert torch.equal(got, attn_block_ref(*args, 4, EPS))


# ---------------------------------------------------------------------------
# the sequences in fp32 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,heads,dh", ATTN_SHAPES[:2])
def test_attn_block_sequence_matches_pallas(b, n, heads, dh):
    args = _attn_args(np.random.default_rng(10 + b), b, n, heads, dh, torch.float32)
    want = np.asarray(jax_attn_block(*(jnp.asarray(t.numpy()) for t in args), heads, EPS))
    got = _attn_sequence(*args, heads, EPS).numpy()
    np.testing.assert_allclose(got, want, rtol=BOUND_PALLAS_ATTN, atol=BOUND_PALLAS_ATTN)


@pytest.mark.parametrize("b,n,d,m", MLP_SHAPES[:2])
def test_mlp_block_sequence_matches_pallas(b, n, d, m):
    args = _mlp_args(np.random.default_rng(20 + b), b, n, d, m, torch.float32)
    want = np.asarray(jax_mlp_block(*(jnp.asarray(t.numpy()) for t in args), EPS))
    got = mlp_block_sequence(*args, EPS, ops=PLAIN_LAUNCHER).numpy()
    np.testing.assert_allclose(got, want, rtol=BOUND_PALLAS_MLP, atol=BOUND_PALLAS_MLP)


# ---------------------------------------------------------------------------
# the model's kernel-layout weights follow a weight load
# ---------------------------------------------------------------------------


def test_vit_features_follow_load_state_dict():
    """The ViT keeps its [in, out] weights (W_q | W_k | W_v side by side)
    across calls; after ``load_state_dict`` of other weights its features are
    those of a model built with them, and a call that autograd records
    builds them afresh."""
    kw = dict(image_size=32, patch_size=16, hidden_size=64, depth=2, num_heads=4)
    model = init_weights(ViTB16(**kw).eval(), torch.Generator().manual_seed(0))
    other = init_weights(ViTB16(**kw).eval(), torch.Generator().manual_seed(1))
    images = _t(_np(np.random.default_rng(3), 2, 32, 32, 3))
    with torch.no_grad():
        first = model(images)
        assert torch.equal(model(images), first)  # the kept weights, reused
        model.load_state_dict(other.state_dict())
        got, want = model(images), other(images)
    assert not torch.equal(got, first)
    assert torch.equal(got, want)
    assert torch.equal(model(images).detach(), want)  # grad mode on: built afresh
