"""The landmark softmax's redesigned kernels (``csrc/landmark.cu`` and
``landmark_bwd.cu``, kernels 1 and 1b), their plain versions and their order
of work emulated in plain torch on the CPU, against the port's JAX-shaped
references and the JAX package's Pallas kernel
(``landmark_pallas.landmark_softmax`` and its ``jax.vjp``, in interpret mode
as the JAX package's own tests run it), on the same inputs made with numpy
from a seed.

- The plain versions of the new formulation (``ops/landmark.py``): the
  forward with the fp32 row log-sum-exp as a fourth output, and the
  backward from (q_l, k_l, lse), which ``LandmarkSoftmax`` runs on CPU
  tensors.
- The emulation of the kernels: the means summed in fp32 over each group's
  real rows in order and scaled by an fp32 1/l; the forward's 64-column
  tiles with the online max and sum in the exp2 form, P = exp2(S log2e -
  lse log2e); the backward's row pass (dot = rowsum(P ga2) over the tiles,
  then dsim rounded and times k_l) and column pass (S^T = k_l q_l^T, P^T
  from lse_i, dsim^T rounded and times q_l); one epilogue, (acc + g) / l
  rounded once and broadcast to each group's real rows.

Shapes: m 40 and 72 (not multiples of 64: a ragged tile), pads that leave
whole groups of pad (n 20 at m 8: group 0; n 150 at m 72: pad 66, groups
0-21), l from 2 to 6, dh 16 and 48.

Tolerances, with their reasons:
- fp32 inputs: max abs error <= 1e-5 (ATOL), the bar of
  tests/test_torch_port_ops.py: the same arithmetic with sums in another
  order, exp2 of log2(e)-scaled logits against exp, and P from lse
  against a division by the row sum;
- bf16 inputs: relative Frobenius error <= BOUND_SINGLE_ROUNDING (1e-2)
  forward and BOUND_BWD (2e-2) backward, chip_smoke.py's bars for the
  kernels: outputs rounded once from fp32 values that differ in their last
  bits, and dsim rounded before its products, so a few values land one
  bf16 ulp apart.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_tpu.ops.landmark_pallas import landmark_softmax as jax_landmark_softmax
from mirror_tpu_torch.ops.landmark import (
    landmark_softmax,
    landmark_softmax_bwd_lse_ref,
    landmark_softmax_bwd_ref,
    landmark_softmax_lse_ref,
    landmark_softmax_ref,
)
from mirror_tpu_torch.scripts._timing import BOUND_BWD, BOUND_SINGLE_ROUNDING
from test_torch_port_runctl import one_intra_op_thread  # noqa: F401 (the fixture)

ATOL = 1e-5
LOG2E = 1.4426950408889634
TILE = 64  # the kernels' walked tiles (BN)
# (b, h, n, dh, m); pad = (m - n % m) % m as the Nystrom attention takes it
SHAPES = [(1, 2, 20, 16, 8), (1, 2, 45, 16, 8), (1, 2, 70, 48, 40), (2, 2, 150, 48, 72)]
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pad(n, m):
    return (m - n % m) % m


@functools.lru_cache(maxsize=None)
def _case(shape, dtype):
    """Inputs (torch, in ``dtype``) and the Pallas kernel's forward and VJP
    on them, computed once per (shape, dtype)."""
    b, h, n, dh, m = shape
    pad = _pad(n, m)
    rng = np.random.default_rng(sum(shape))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, h, n, dh), (b, h, n, dh), (b, h, m, dh), (b, h, m, dh), (b, h, m, m))]
    arrays[0] *= dh ** -0.5
    t_dtype, j_dtype = DTYPES[dtype]
    torch_in = [torch.from_numpy(a).to(t_dtype) for a in arrays]
    jq, jk, jgql, jgkl, jga2 = (jnp.asarray(a, j_dtype) for a in arrays)
    fwd, vjp = jax.vjp(lambda q, k: jax_landmark_softmax(q, k, m, pad), jq, jk)
    jax_fwd = [torch.from_numpy(np.array(x, np.float32)) for x in fwd]
    jax_bwd = [torch.from_numpy(np.array(x, np.float32)) for x in vjp((jgql, jgkl, jga2))]
    return torch_in, jax_fwd, jax_bwd


def _assert_near(out, ref, dtype, bound, name):
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape, name
    if dtype == "fp32":
        err = (out - ref).abs().max().item()
        assert err <= ATOL, f"{name}: max abs error {err} > {ATOL}"
    else:
        err = ((out - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        assert err <= bound, f"{name}: relative Frobenius error {err} > {bound}"


# ---------------------------------------------------------------------------
# the kernels' order of work
# ---------------------------------------------------------------------------


def means_emulation(x, m, pad):
    """Kernel 1's first launch: each group's real rows summed in fp32 in
    order (the front pad's rows are skipped: zeros), times an fp32 1/l,
    rounded once."""
    b, h, n, dh = x.shape
    l = (n + pad) // m
    s = torch.zeros(b, h, m, dh)
    for j in range(l):
        rows = torch.arange(m) * l - pad + j
        real = rows >= 0
        s[:, :, real] += x[:, :, rows[real]].float()
    return (s * torch.tensor(1.0 / l, dtype=torch.float32)).to(x.dtype)


def forward_emulation(q, k, m, pad):
    """(q_l, k_l, attn2, lse) in the kernels' order: sweep 1 keeps the online
    max and sum over 64-column tiles in the exp2 form, lse = max + log(sum);
    sweep 2 writes P = exp2(S log2e - lse log2e) rounded."""
    q_l, k_l = means_emulation(q, m, pad), means_emulation(k, m, pad)
    sim = q_l.float() @ k_l.float().transpose(-1, -2)
    mx = torch.full(sim.shape[:-1], -torch.inf)
    total = torch.zeros(sim.shape[:-1])
    for c0 in range(0, m, TILE):
        s = sim[..., c0:c0 + TILE]
        new = torch.maximum(mx, s.amax(-1))
        total = total * torch.exp2((mx - new) * LOG2E) \
            + torch.exp2(s * LOG2E - (new * LOG2E).unsqueeze(-1)).sum(-1)
        mx = new
    lse = mx + torch.log(total)
    p = torch.exp2(sim * LOG2E - (lse * LOG2E).unsqueeze(-1))
    return q_l, k_l, p.to(q.dtype), lse


def _broadcast_groups(acc, g, n, pad):
    """The epilogue: (acc + g) / l rounded once, each group's value written
    to its real rows (the groups made only of pad write nothing)."""
    m = acc.shape[2]
    l = (n + pad) // m
    val = ((acc + g.float()) * torch.tensor(1.0 / l, dtype=torch.float32)).to(g.dtype)
    return val[:, :, (torch.arange(n) + pad) // l]


def backward_emulation(q_l, k_l, lse, n, pad, gql, gkl, ga2):
    """(dq, dk) in the kernels' order: the row pass (dot over the column
    tiles, then dsim rounded and times k_l, tile by tile) and the column
    pass (the transposed scores k_l q_l^T, P^T from each row's lse, dsim^T
    rounded and times q_l, tile by tile)."""
    m, dtype = q_l.shape[2], q_l.dtype
    ql, kl, g2 = q_l.float(), k_l.float(), ga2.float()
    lse2 = (lse * LOG2E).unsqueeze(-1)
    p = torch.exp2((ql @ kl.transpose(-1, -2)) * LOG2E - lse2)
    dot = torch.zeros(lse.shape)
    for c0 in range(0, m, TILE):
        dot += (p[..., c0:c0 + TILE] * g2[..., c0:c0 + TILE]).sum(-1)
    acc_q = torch.zeros(ql.shape)
    for c0 in range(0, m, TILE):
        pt, gt = p[..., c0:c0 + TILE], g2[..., c0:c0 + TILE]
        dsim = (pt * gt - pt * dot.unsqueeze(-1)).to(dtype).float()
        acc_q += dsim @ kl[:, :, c0:c0 + TILE]
    p_t = torch.exp2((kl @ ql.transpose(-1, -2)) * LOG2E - lse2.transpose(-1, -2))
    acc_k = torch.zeros(kl.shape)
    for i0 in range(0, m, TILE):
        pt, gt = p_t[..., i0:i0 + TILE], g2[:, :, i0:i0 + TILE].transpose(-1, -2)
        dsim_t = (pt * gt - pt * dot[..., None, i0:i0 + TILE]).to(dtype).float()
        acc_k += dsim_t @ ql[:, :, i0:i0 + TILE]
    return _broadcast_groups(acc_q, gql, n, pad), _broadcast_groups(acc_k, gkl, n, pad)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_with_lse_matches_pallas(shape, dtype):
    (q, k, *_), jax_fwd, _ = _case(shape, dtype)
    m, pad = shape[4], _pad(shape[2], shape[4])
    out = landmark_softmax_lse_ref(q, k, m, pad)
    for name, o, r in zip(("q_l", "k_l", "attn2"), out, jax_fwd):
        _assert_near(o, r, dtype, BOUND_SINGLE_ROUNDING, name)
    ql, kl = jax_fwd[0], jax_fwd[1]
    want = torch.logsumexp(ql @ kl.transpose(-1, -2), dim=-1)
    assert out[3].dtype == torch.float32
    assert (out[3] - want).abs().max().item() <= ATOL


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_from_lse_matches_pallas(shape, dtype):
    (q, k, gql, gkl, ga2), _, jax_bwd = _case(shape, dtype)
    n, m = shape[2], shape[4]
    pad = _pad(n, m)
    q_l, k_l, _, lse = landmark_softmax_lse_ref(q, k, m, pad)
    out = landmark_softmax_bwd_lse_ref(q_l, k_l, lse, n, pad, gql, gkl, ga2)
    ref = landmark_softmax_bwd_ref(q, k, m, pad, gql, gkl, ga2)
    for name, o, r, j in zip(("dq", "dk"), out, ref, jax_bwd):
        assert o.dtype == q.dtype, name
        _assert_near(o, r, dtype, BOUND_BWD, name)
        _assert_near(o, j, dtype, BOUND_BWD, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_emulation_matches_references(shape, dtype):
    (q, k, *_), jax_fwd, _ = _case(shape, dtype)
    m, pad = shape[4], _pad(shape[2], shape[4])
    emu = forward_emulation(q, k, m, pad)
    ref = landmark_softmax_lse_ref(q, k, m, pad)
    for name, e, r, j in zip(("q_l", "k_l", "attn2"), emu, ref, jax_fwd):
        _assert_near(e, r, dtype, BOUND_SINGLE_ROUNDING, name)
        _assert_near(e, j, dtype, BOUND_SINGLE_ROUNDING, name)
    assert (emu[3] - ref[3]).abs().max().item() <= ATOL


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_emulation_matches_references(shape, dtype):
    (q, k, gql, gkl, ga2), _, jax_bwd = _case(shape, dtype)
    n, m = shape[2], shape[4]
    pad = _pad(n, m)
    q_l, k_l, _, lse = forward_emulation(q, k, m, pad)
    emu = backward_emulation(q_l, k_l, lse, n, pad, gql, gkl, ga2)
    ref = landmark_softmax_bwd_ref(q, k, m, pad, gql, gkl, ga2)
    for name, e, r, j in zip(("dq", "dk"), emu, ref, jax_bwd):
        assert e.dtype == q.dtype, name
        _assert_near(e, r, dtype, BOUND_BWD, name)
        _assert_near(e, j, dtype, BOUND_BWD, name)


@pytest.mark.parametrize("shape", SHAPES)
def test_pad_groups_get_no_gradient_and_real_rows_share_their_group(shape):
    """The groups made only of pad own no real row, and each real row takes
    its group's rounded value: rows of one group hold equal gradients."""
    (q, k, gql, gkl, ga2), _, _ = _case(shape, "fp32")
    n, m = shape[2], shape[4]
    pad = _pad(n, m)
    l = (n + pad) // m
    q_l, k_l, _, lse = forward_emulation(q, k, m, pad)
    dq, _ = backward_emulation(q_l, k_l, lse, n, pad, gql, gkl, ga2)
    group = (torch.arange(n) + pad) // l
    assert group.min().item() == pad // l  # groups 0 .. pad // l - 1 are all pad
    for grp in group.unique():
        rows = dq[:, :, group == grp]
        assert torch.equal(rows, rows[:, :, :1].expand_as(rows))


@pytest.mark.parametrize("shape", SHAPES[2:])
def test_autograd_function_runs_the_new_plain_path(shape):
    """LandmarkSoftmax on CPU tensors: its backward (from the saved q_l, k_l
    and lse) gives landmark_softmax_bwd_ref's gradients."""
    (q, k, gql, gkl, ga2), _, _ = _case(shape, "fp32")
    m, pad = shape[4], _pad(shape[2], shape[4])
    leaves = [q.clone().requires_grad_(), k.clone().requires_grad_()]
    outs = landmark_softmax(*leaves, m, pad)
    grads = torch.autograd.grad(outs, leaves, (gql, gkl, ga2))
    for name, g, r in zip(("dq", "dk"), grads, landmark_softmax_bwd_ref(q, k, m, pad, gql, gkl,
                                                                         ga2)):
        _assert_near(g, r, "fp32", BOUND_BWD, name)
    for o, r in zip(outs, landmark_softmax_ref(q, k, m, pad)):
        assert torch.equal(o, r)
