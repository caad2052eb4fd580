"""The pinv's launch sequences (kernels 2 and 2b, ``csrc/pinv.cu``) on the
CPU, through plain versions of its C entries, held against the port's plain
iterations and the JAX package's Pallas kernel.

On the card ``ops/pinv.py`` runs the pinv as launches of one batched GEMM
(``mirror_pinv_gemm``) and three helpers. Here the same launch sequences
(``pinv_sequence``, ``pinv_exact_bwd_sequence``) take ``PLAIN_LAUNCHER``,
the plain versions of those four entries, as their launcher parameter, so
the order of the launches, their operand layouts, epilogues and buffers are
checked without a card. Inputs are made from numpy seeds.

Tolerances, with their reasons:
- ``gemm_ref`` against a float64 product: bf16 outputs within 2^-7 of the
  largest magnitude (the fp32 and the float64 sums round to the same or a
  neighbouring bf16 value: one ulp is 2^-8 relative, and the epilogue adds
  an identity term that can raise an exponent), fp32 outputs within 1e-5
  (sums of the same products in another order);
- the sequences against ``pinv_iterations_ref`` and ``pinv_exact_bwd_ref``
  in bf16: bit for bit for z and gx (the same products and the same
  rounding points, taken in the same order on the CPU), gs within 1e-6
  relative (per-matrix partials summed in another shape);
- against the Pallas kernels in interpret mode, in fp32 (every rounding
  point is then the identity): z within 1e-4 and gx, gs within 1e-5 of the
  largest magnitude, the bars of tests/test_torch_port_pinv_exact.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.ops import pinv_pallas
from mirror_tpu_torch.ops import _common
from mirror_tpu_torch.ops.pinv import (
    PLAIN_LAUNCHER,
    _ACC32,
    _ADD,
    _EYE,
    _NN,
    _NT,
    _TN,
    bwd_finish_ref,
    eye_axpby_ref,
    gemm_ref,
    global_scale,
    init_ref,
    pinv_exact_bwd_ref,
    pinv_exact_bwd_sequence,
    pinv_iterations_ref,
    pinv_sequence,
)
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

BOUND_GEMM_BF16, BOUND_GEMM_FP32 = 2.0 ** -7, 1e-5
BOUND_GS = 1e-6
BOUND_PALLAS_Z, BOUND_PALLAS_GRAD = 1e-4, 1e-5


def _max_rel(a, b):
    a, b = (t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
            for t in (a, b))
    return np.abs(a - b).max() / np.abs(b).max()


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# one launch: gemm_ref keeps mirror_pinv_gemm's contract
# ---------------------------------------------------------------------------

LAYOUTS = {"NN": _NN, "NT": _NT, "TN": _TN}


@pytest.mark.parametrize("epilogue", ["eye", "eye_c2", "add_aliased", "acc32"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gemm_ref_contract(layout, epilogue):
    """P = op(a) op(b) on [bh, M, K] x [bh, K, N] (M, N, K unequal, none a
    multiple of 8), each epilogue at its rounding points."""
    bh, M, N, K = 3, 13, 11, 7
    rng = np.random.default_rng(100)
    a_op = rng.standard_normal((bh, M, K))
    b_op = rng.standard_normal((bh, K, N))
    a = _bf16(a_op.transpose(0, 2, 1) if layout == "TN" else a_op)
    b = _bf16(b_op.transpose(0, 2, 1) if layout == "NT" else b_op)
    a_val = a.double().numpy()
    b_val = b.double().numpy()
    p = (a_val.transpose(0, 2, 1) if layout == "TN" else a_val) @ (
        b_val.transpose(0, 2, 1) if layout == "NT" else b_val)
    p_bf16 = _bf16(p).double().numpy()
    eye = np.eye(M, N)
    c = torch.zeros(bh, M, N, dtype=torch.bfloat16)
    kw = dict(layout=LAYOUTS[layout])
    if epilogue == "acc32":
        acc0 = rng.standard_normal((bh, M, N)).astype(np.float32)
        acc = torch.from_numpy(acc0.copy())
        gemm_ref(a, b, acc=acc, epilogue=_ACC32, **kw)
        assert acc.dtype == torch.float32
        assert _max_rel(acc, acc0 + p) <= BOUND_GEMM_FP32
        return
    if epilogue == "add_aliased":
        c.copy_(_bf16(rng.standard_normal((bh, M, N))))
        want = c.double().numpy() - 0.5 * p_bf16
        gemm_ref(a, b, c, prev=c, epilogue=_ADD, c1=-0.5, **kw)  # prev is c itself
        assert _max_rel(c, want) <= BOUND_GEMM_BF16
        return
    c2 = torch.zeros_like(c) if epilogue == "eye_c2" else None
    gemm_ref(a, b, c, c2, epilogue=_EYE, c0=7.0, c1=-1.0, d0=15.0, d1=-0.25, **kw)
    want = 7.0 * eye - p_bf16
    assert _max_rel(c, want) <= BOUND_GEMM_BF16
    if c2 is not None:  # from c as rounded
        assert _max_rel(c2, 15.0 * eye - 0.25 * c.double().numpy()) <= BOUND_GEMM_BF16


def test_plain_helpers_contract():
    """mirror_pinv_init, mirror_pinv_eye_axpby and mirror_pinv_bwd_finish as
    plain versions: z0 = bf16(x^T / s); out = bf16(c0 I + c1 in); gx =
    bf16(gx32 + gz^T / s) and gs[bh] = -sum(gz z0) / s."""
    rng = np.random.default_rng(101)
    bh, m = 2, 9
    x = _bf16(rng.standard_normal((bh, m, m)))
    s = torch.tensor(3.0)
    z = torch.empty_like(x)
    init_ref(x, s, z)
    assert _max_rel(z, x.double().numpy().transpose(0, 2, 1) / 3.0) <= BOUND_GEMM_BF16
    out = torch.empty_like(x)
    eye_axpby_ref(x, out, 7.0, -1.0)
    assert _max_rel(out, 7.0 * np.eye(m) - x.double().numpy()) <= BOUND_GEMM_BF16
    gx32 = torch.from_numpy(rng.standard_normal((bh, m, m)).astype(np.float32))
    gx, gs = torch.empty_like(x), torch.empty(bh)
    bwd_finish_ref(gx32, x, z, s, gx, gs)
    xd, zd = x.double().numpy(), z.double().numpy()
    assert _max_rel(gx, gx32.double().numpy() + xd.transpose(0, 2, 1) / 3.0) <= BOUND_GEMM_BF16
    assert _max_rel(gs, -(xd * zd).sum((1, 2)) / 3.0) <= BOUND_GEMM_FP32


# ---------------------------------------------------------------------------
# the launch sequences
# ---------------------------------------------------------------------------


def _softmax_like(seed, m, b=1, h=2):
    rng = np.random.default_rng(seed)
    sim = rng.standard_normal((b, h, m, m)).astype(np.float32)
    x = np.exp(sim - sim.max(-1, keepdims=True))
    x /= x.sum(-1, keepdims=True)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, g


# m: a multiple of 8 below one tile, not a multiple of 8 (the kernel's
# element-wise staging), and a multiple of 8 but not of the 128-wide tile
SIZES = [32, 100, 136]


@pytest.mark.parametrize("iters", [6, 0])
@pytest.mark.parametrize("m", SIZES)
def test_forward_sequence_is_the_plain_iterations(m, iters):
    x, _ = _softmax_like(102, m)
    xt = torch.from_numpy(x).bfloat16()
    s = global_scale(xt)
    _common.reset_launch_counts()
    z = pinv_sequence(xt, s, iters, PLAIN_LAUNCHER)
    assert _common.launch_counts() == {}  # nothing was launched
    assert z.dtype == torch.bfloat16
    assert torch.equal(z, pinv_iterations_ref(xt, s, iters))


@pytest.mark.parametrize("stash", [4, 2, 1])
@pytest.mark.parametrize("iters", [6, 0])
@pytest.mark.parametrize("m", SIZES)
def test_backward_sequence_is_the_plain_backward(m, iters, stash):
    x, g = _softmax_like(103, m)
    xt, gt = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    s = global_scale(xt)
    gx, gs = pinv_exact_bwd_sequence(xt, s, gt, iters, stash, PLAIN_LAUNCHER)
    gx_ref, gs_ref = pinv_exact_bwd_ref(xt, s, gt, iters)
    assert gx.dtype == torch.bfloat16 and gs.shape == () and gs.dtype == torch.float32
    assert torch.equal(gx, gx_ref)
    assert abs(gs.item() - gs_ref.item()) <= BOUND_GS * abs(gs_ref.item())


@pytest.mark.parametrize("iters", [6, 0])
@pytest.mark.parametrize("m", SIZES)
def test_sequences_match_pallas(m, iters):
    """fp32: the forward against ``moore_penrose_pinv_pallas`` and the
    backward against the Pallas backward body (``_bwd_call``), both in
    interpret mode."""
    x, g = _softmax_like(104, m)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    s = global_scale(xt)
    xj = jnp.asarray(x)
    z = pinv_sequence(xt, s, iters, PLAIN_LAUNCHER)
    want = pinv_pallas.moore_penrose_pinv_pallas(xj, iters, grad="exact")
    assert _max_rel(z.numpy(), want) <= BOUND_PALLAS_Z
    gx, gs = pinv_exact_bwd_sequence(xt, s, gt, iters, 4, PLAIN_LAUNCHER)
    gx_j, gs_j = pinv_pallas._bwd_call(xj, jnp.float32(s.item()), jnp.asarray(g), iters)
    assert _max_rel(gx.numpy(), gx_j) <= BOUND_PALLAS_GRAD
    assert abs(gs.item() - float(gs_j)) <= BOUND_PALLAS_GRAD * abs(float(gs_j))


def test_stash_is_checked_before_any_launch():
    x, g = _softmax_like(105, 32)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="stash"):
        pinv_exact_bwd_sequence(xt, global_scale(xt), torch.from_numpy(g), 6, 3, PLAIN_LAUNCHER)
