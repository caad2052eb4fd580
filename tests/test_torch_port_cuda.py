"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (sm_90a) and nvcc; without one they skip.
They import neither jax nor the JAX package, so they also run where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Inputs are bf16, the kernels' first type, except where a test names
float32 or float16 (the instances of --no-amp and --amp-dtype float16, with
their own bars, below). Bounds, with their reasons:
- outputs rounded once to bf16 after an fp32 sum taken in another order
  (landmark means and softmax, attention, PPEG): max abs error <= 1e-2 of
  the reference's largest magnitude (a bf16 ulp is 2^-8 = 3.9e-3 relative;
  the attention also rounds its probabilities before the product);
- the pinv, whose 6 iterations amplify one-ulp differences of 24 chained
  bf16 products: held by function, |x z - I| no worse than 1.5x the plain
  version's (or 0.05), as the JAX package's bf16 pinv test holds it;
- the exact pinv backward (2b): see BOUND_PINV_BWD below;
- the backward kernels, against their plain versions fed the same bf16
  inputs and incoming gradient: relative Frobenius error <= 2e-2 per
  output. Each output is rounded once to bf16 (2^-9 relative), but dsim is
  rounded too before its products, and a probability that the kernel and
  the plain version compute one fp32 ulp apart can round dsim to the next
  bf16 value; dk and dq are sums of such terms with cancellation;
- the sums over a whole batch (dkern of the standalone conv; gw, gs and gb
  of the fused LN + q/k/v projection): max abs error <= 1e-2 of the
  reference's largest magnitude where the output is rounded to bf16 (gw,
  dkern for bf16 taps), 1e-4 where it stays fp32 (the same bf16 products
  summed in another order).
"""

import pytest
import torch

from mirror_tpu_torch.ops import _common, landmark
from mirror_tpu_torch.ops.conv1d import depthwise_conv1d_seq
from mirror_tpu_torch.ops.landmark import (
    landmark_softmax,
    landmark_softmax_bwd_ref,
    landmark_softmax_ref,
)
from mirror_tpu_torch.ops.nystrom_attn import (
    _launch_bwd,
    _launch_fwd,
    depthwise_conv_seq_bwd_ref,
    depthwise_conv_seq_ref,
    fused_softmax_attn,
    fused_softmax_attn_conv,
    softmax_attn_bwd_lse_ref,
    softmax_attn_bwd_ref,
    softmax_attn_fwd_ref,
    softmax_attn_ref,
)
from mirror_tpu_torch.ops.pinv import (
    _ACC32,
    _ADD,
    _EYE,
    _NN,
    _NT,
    _TN,
    _launch_gemm,
    _pinv_exact_bwd_kernel,
    gemm_ref,
    global_scale,
    moore_penrose_pinv,
    pinv_exact_bwd_ref,
    pinv_iterations_ref,
)
from mirror_tpu_torch.ops.ln_qkv import ln_qkv_bwd_ref, ln_qkv_fused, ln_qkv_ref
from mirror_tpu_torch.ops.ppeg import ppeg_bwd_ref, ppeg_fused, ppeg_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, *shape, dev, scale=1.0, dtype=torch.bfloat16):
    x = torch.randn(*shape, generator=gen) * scale
    return x.to(device=dev, dtype=dtype)


def _assert_close(out, ref, rel=1e-2):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    bound = rel * ref.float().abs().max().item()
    assert err <= bound, f"max abs error {err} > {bound}"


def _gemm_launches(iters, backward=None):
    """Launches of the pinv's GEMM: 4 an iteration forward; the exact
    backward's replay (its last z product skipped) and sweep, 12 an
    iteration, and 2 (stash 2) or 3 (stash 1) more to recompute."""
    if backward is None:
        return 4 * iters
    return (12 + {4: 0, 2: 2, 1: 3}[backward]) * iters - 1 if iters else 0


# (b, h, n, dh, m): pad 4 (group 0 all pad), pad 3, the slice's two Nystrom
# shapes and the self-test's; m 40 (not a multiple of 64: a ragged tile);
# m 1024 (pad 955, l 3), which the earlier design (a [64, m] fp32 block in
# shared memory) refused at launch
LANDMARK_SHAPES = [(1, 2, 20, 16, 8), (1, 2, 45, 16, 8), (2, 8, 2117, 96, 384),
                   (2, 8, 2049, 96, 384), (2, 8, 2117, 64, 256), (1, 2, 70, 48, 40),
                   (1, 2, 2117, 64, 1024)]


@pytest.mark.parametrize("b,h,n,dh,m", LANDMARK_SHAPES)
def test_landmark_softmax_kernel(dev, b, h, n, dh, m):
    g = torch.Generator().manual_seed(0)
    q, k = _randn(g, b, h, n, dh, dev=dev), _randn(g, b, h, n, dh, dev=dev)
    pad = (m - n % m) % m
    for o, r in zip(landmark_softmax(q, k, m, pad), landmark_softmax_ref(q, k, m, pad)):
        _assert_close(o, r)


@pytest.mark.parametrize("b,h,n,dh,m", LANDMARK_SHAPES)
def test_landmark_softmax_lse_kernel(dev, b, h, n, dh, m):
    """The forward's residual, the fp32 row log-sum-exp of q_l k_l^T, against
    a direct fp32 logsumexp of the kernel's own q_l and k_l: max abs error
    <= 1e-4 (fp32 sums in another order and ex2.approx's 2 ulp, on values
    of magnitude about 10)."""
    g = torch.Generator().manual_seed(0)
    q = _randn(g, b, h, n, dh, dev=dev, scale=dh ** -0.5)
    k = _randn(g, b, h, n, dh, dev=dev)
    pad = (m - n % m) % m
    q_l, k_l, _, lse = landmark._launch_fwd(q, k, m, pad)
    want = torch.logsumexp(q_l.float() @ k_l.float().transpose(-1, -2), dim=-1)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (b, h, m)
    assert (lse - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,h,m", [(1, 2, 32), (2, 8, 384), (1, 1, 100), (2, 8, 256)])
def test_pinv_kernel(dev, b, h, m):
    g = torch.Generator().manual_seed(1)
    x = torch.softmax(torch.randn(b, h, m, m, generator=g), -1).to(dev, torch.bfloat16)
    z = moore_penrose_pinv(x)
    z_ref = pinv_iterations_ref(x, global_scale(x))
    torch.cuda.synchronize()
    eye = torch.eye(m, device=dev)
    err = (x.float() @ z.float() - eye).abs().max().item()
    err_ref = (x.float() @ z_ref.float() - eye).abs().max().item()
    assert err <= max(1.5 * err_ref, 0.05), (err, err_ref)


@pytest.mark.parametrize("b,h,r,c,dh,pad", [(1, 2, 8, 40, 16, 24), (2, 3, 70, 130, 32, 0),
                                            (1, 8, 384, 2117, 96, 187),
                                            (1, 8, 384, 2049, 96, 255),
                                            (1, 8, 256, 2117, 64, 187)])
def test_softmax_attn_kernel(dev, b, h, r, c, dh, pad):
    g = torch.Generator().manual_seed(2)
    q = _randn(g, b, h, r, dh, dev=dev, scale=dh ** -0.5)
    k, w = _randn(g, b, h, c, dh, dev=dev), _randn(g, b, h, c, dh, dev=dev)
    out = fused_softmax_attn(q, k, w, pad)
    _assert_close(out, softmax_attn_ref(q, k, w, pad).to(q.dtype))


@pytest.mark.parametrize("b,h,n,m,dh", [(1, 2, 10, 8, 16), (2, 3, 70, 16, 32),
                                        (1, 8, 2117, 384, 96), (1, 8, 2049, 384, 96),
                                        (1, 8, 2117, 256, 64)])
def test_softmax_attn_conv_kernel(dev, b, h, n, m, dh):
    g = torch.Generator().manual_seed(3)
    q = _randn(g, b, h, n, dh, dev=dev, scale=dh ** -0.5)
    v = _randn(g, b, h, n, dh, dev=dev)
    k_l, w = _randn(g, b, h, m, dh, dev=dev), _randn(g, b, h, m, dh, dev=dev)
    kern = _randn(g, h, 33, dev=dev, scale=0.1)
    out = fused_softmax_attn_conv(q, k_l, w, v, kern)
    ref = softmax_attn_ref(q, k_l, w) + depthwise_conv_seq_ref(v, kern)
    _assert_close(out, ref.to(q.dtype))


@pytest.mark.parametrize("b,H,W,C", [(1, 5, 7, 40), (2, 46, 46, 768), (2, 46, 46, 512)])
def test_ppeg_kernel(dev, b, H, W, C):
    g = torch.Generator().manual_seed(4)
    img = _randn(g, b, H, W, C, dev=dev)
    kern, bias = _randn(g, 7, 7, C, dev=dev, scale=0.1), _randn(g, C, dev=dev, scale=0.1)
    _assert_close(ppeg_fused(img, kern, bias), ppeg_ref(img, kern, bias))


def ppeg_dydx_order(img, kern, bias):
    """PPEG as kernel 5 (and the kernel it replaced) sums it: img + b in
    fp32, then the 49 taps in (dy, dx) order (a product of two bf16 values
    is exact in fp32, so an fp32 multiply and add give fmaf's bits), one
    rounding to img's dtype. tests/test_torch_port_attn_ppeg_design.py holds
    its emulation of kernel 5 to this too."""
    H, W = img.shape[1:3]
    xp = torch.nn.functional.pad(img.float(), (0, 0, 3, 3, 3, 3))
    acc = img.float() + bias.float()
    for dy in range(7):
        for dx in range(7):
            acc = acc + kern.float()[dy, dx] * xp[:, dy:dy + H, dx:dx + W]
    return acc.to(img.dtype)


# (b, H, W, C): test_ppeg_kernel's shapes, and H not a multiple of the 8-row
# bands, W not of the 16-column chunks, C not of the 64-channel blocks, odd C
@pytest.mark.parametrize("b,H,W,C", [(1, 5, 7, 40), (2, 46, 46, 768), (2, 46, 46, 512),
                                     (3, 13, 21, 40), (1, 11, 19, 37), (1, 9, 3, 72)])
def test_ppeg_kernel_sums_in_dy_dx_order(dev, b, H, W, C):
    """Kernel 5 bit for bit the (dy, dx)-order sum, and two runs bit for bit."""
    g = torch.Generator().manual_seed(40)
    img = _randn(g, b, H, W, C, dev=dev)
    kern, bias = _randn(g, 7, 7, C, dev=dev, scale=0.1), _randn(g, C, dev=dev, scale=0.1)
    out = ppeg_fused(img, kern, bias)
    torch.cuda.synchronize()
    assert torch.equal(out, ppeg_dydx_order(img, kern, bias))
    assert torch.equal(out, ppeg_fused(img, kern, bias))


def test_kernels_count_launches_and_reject_bad_inputs(dev):
    _common.reset_launch_counts()
    x = torch.randn(1, 5, 7, 32, device=dev, dtype=torch.bfloat16)
    ppeg_fused(x, x.new_zeros(7, 7, 32), x.new_zeros(32))
    assert _common.launch_counts() == {"ppeg": 1}
    with pytest.raises(TypeError):
        ppeg_fused(x.float(), x.new_zeros(7, 7, 32), x.new_zeros(32))
    with pytest.raises(ValueError):  # mixed devices
        ppeg_fused(x, x.new_zeros(7, 7, 32).cpu(), x.new_zeros(32))
    # a kernel's output keeps its autograd history, and the backward is a
    # kernel too
    img = x.clone().requires_grad_()
    out = ppeg_fused(img, x.new_zeros(7, 7, 32), x.new_zeros(32))
    assert out.requires_grad
    out.float().sum().backward()
    assert _common.launch_counts() == {"ppeg": 2, "ppeg_bwd": 1}
    assert img.grad is not None and img.grad.shape == img.shape


def test_classifier_kernel_path_matches_cpu_plain_path(dev):
    """A small MIRRORClassifier (embed 384: dh 48, 192 landmarks, 37 rows, so
    pad 155; 12 RNA heads) on the card's kernels against the CPU's plain
    path, both bf16: logits within 5e-2 relative (bf16 drift through two
    Nystrom layers and their pinvs)."""
    from mirror_tpu_torch.registry import create_model

    kw = dict(wsi_embed_dim=32, rna_embed_dim=96, embed_dim=384, rna_mlp_ratio=2.0,
              num_classes=3, dtype="bfloat16")
    cpu = create_model("mirror_classifier", device="cpu",
                       generator=torch.Generator().manual_seed(5), **kw)
    gpu = create_model("mirror_classifier", device=dev, **kw)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(6)
    wsi, rna = torch.randn(2, 30, 32, generator=g), torch.randn(2, 96, generator=g)
    _common.reset_launch_counts()
    with torch.no_grad():
        got = gpu(wsi.to(dev), rna.to(dev)).float().cpu()
        want = cpu(wsi, rna).float()
    assert _common.launch_counts() == {"landmark_softmax": 2, "moore_penrose_pinv": 2,
                                       "pinv_gemm": 2 * _gemm_launches(6),
                                       "softmax_attn": 2, "softmax_attn_conv": 2, "ppeg": 1}
    assert ((got - want).norm() / want.norm()).item() <= 5e-2, (got, want)


BOUND_BWD = 2e-2


def _grads(fn, *inputs):
    """(output, grads of every input) of fn through autograd, for an
    incoming gradient drawn from a seeded generator."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator().manual_seed(9)
    gouts = [torch.randn(o.shape, generator=gen).to(o.device, o.dtype) for o in outs]
    torch.autograd.backward(outs, gouts)
    return gouts, [t.grad for t in leaves]


def _assert_rel(out, ref, bound=BOUND_BWD, name=""):
    torch.cuda.synchronize()
    assert out.shape == ref.shape, name
    assert torch.isfinite(out.float()).all(), name
    err = ((out.float() - ref.float()).norm() / ref.float().norm().clamp_min(1e-30)).item()
    assert err <= bound, f"{name}: relative Frobenius error {err} > {bound}"


# LANDMARK_SHAPES: the encoder's 2117 rows with pad 187 leave groups 0-30
# all pad, the retention decoder's 2049 rows with pad 255 groups 0-41, and
# m 1024's pad 955 groups 0-318
@pytest.mark.parametrize("b,h,n,dh,m", LANDMARK_SHAPES)
def test_landmark_softmax_bwd_kernel(dev, b, h, n, dh, m):
    g = torch.Generator().manual_seed(10)
    q = _randn(g, b, h, n, dh, dev=dev, scale=dh ** -0.5)
    k = _randn(g, b, h, n, dh, dev=dev)
    pad = (m - n % m) % m
    _common.reset_launch_counts()
    gouts, (dq, dk) = _grads(lambda q, k: landmark_softmax(q, k, m, pad), q, k)
    assert _common.launch_counts() == {"landmark_softmax": 1, "landmark_softmax_bwd": 1}
    ref = landmark_softmax_bwd_ref(q, k, m, pad, *gouts)
    _assert_rel(dq, ref[0], name="dq")
    _assert_rel(dk, ref[1], name="dk")


@pytest.mark.parametrize("b,h,n,dh,m", [(2, 8, 2117, 96, 384), (1, 2, 70, 48, 40)])
def test_landmark_softmax_bwd_kernel_repeats_bitwise(dev, b, h, n, dh, m):
    """One block owns each output tile and sums in a fixed order, with no
    float atomics: two backward runs on the same inputs give the same bits."""
    g = torch.Generator().manual_seed(10)
    q = _randn(g, b, h, n, dh, dev=dev, scale=dh ** -0.5)
    k = _randn(g, b, h, n, dh, dev=dev)
    pad = (m - n % m) % m
    leaves = [q.requires_grad_(), k.requires_grad_()]
    outs = landmark_softmax(*leaves, m, pad)
    grads = [_randn(g, *o.shape, dev=dev) for o in outs]
    first = torch.autograd.grad(outs, leaves, grads, retain_graph=True)
    again = torch.autograd.grad(outs, leaves, grads)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("b,h,r,c,dh,pad", [(1, 2, 8, 40, 16, 24), (2, 3, 70, 130, 32, 0),
                                            (2, 8, 384, 2117, 96, 187),
                                            (2, 8, 384, 2049, 96, 255),
                                            (2, 8, 256, 2117, 64, 187)])
def test_softmax_attn_bwd_kernel(dev, b, h, r, c, dh, pad):
    g = torch.Generator().manual_seed(11)
    q = _randn(g, b, h, r, dh, dev=dev, scale=dh ** -0.5)
    k, w = _randn(g, b, h, c, dh, dev=dev), _randn(g, b, h, c, dh, dev=dev)
    _common.reset_launch_counts()
    (gout,), grads = _grads(lambda q, k, w: fused_softmax_attn(q, k, w, pad), q, k, w)
    assert _common.launch_counts() == {"softmax_attn": 1, "softmax_attn_bwd": 1}
    for name, got, want in zip(("dq", "dk", "dw"), grads,
                               softmax_attn_bwd_ref(q, k, w, gout, pad)):
        _assert_rel(got, want.to(got.dtype), name=name)


@pytest.mark.parametrize("b,h,n,m,dh", [(1, 2, 10, 8, 16), (2, 3, 70, 16, 32),
                                        (2, 8, 2117, 384, 96), (2, 8, 2049, 384, 96),
                                        (2, 8, 2117, 256, 64)])
def test_softmax_attn_conv_bwd_kernel(dev, b, h, n, m, dh):
    g = torch.Generator().manual_seed(12)
    q = _randn(g, b, h, n, dh, dev=dev, scale=dh ** -0.5)
    v = _randn(g, b, h, n, dh, dev=dev)
    k_l, w = _randn(g, b, h, m, dh, dev=dev), _randn(g, b, h, m, dh, dev=dev)
    kern = _randn(g, h, 33, dev=dev, scale=0.1)
    _common.reset_launch_counts()
    (gout,), grads = _grads(fused_softmax_attn_conv, q, k_l, w, v, kern)
    assert _common.launch_counts() == {"softmax_attn_conv": 1, "softmax_attn_conv_bwd": 1}
    want = [*softmax_attn_bwd_ref(q, k_l, w, gout), *depthwise_conv_seq_bwd_ref(v, kern, gout)]
    for name, got, ref in zip(("dq", "dk_l", "dw", "dv", "dkern"), grads, want):
        _assert_rel(got, ref.to(got.dtype), name=name)


# the attention's residuals: (b, h, r, c, dh, pad, conv); conv runs the
# fused-conv instance (kernel 4), whose o_attn is the attention part alone
ATTN_RESIDUAL_SHAPES = [(1, 2, 8, 40, 16, 24, False), (2, 3, 70, 130, 32, 0, False),
                        (1, 2, 10, 8, 16, 0, True), (1, 8, 384, 2117, 96, 187, False),
                        (1, 8, 384, 2049, 96, 255, False), (1, 8, 256, 2117, 64, 187, False),
                        (1, 8, 2117, 384, 96, 0, True)]


def _attn_inputs(seed, b, h, r, c, dh, dev):
    g = torch.Generator().manual_seed(seed)
    q = _randn(g, b, h, r, dh, dev=dev, scale=dh ** -0.5)
    k, w = _randn(g, b, h, c, dh, dev=dev), _randn(g, b, h, c, dh, dev=dev)
    v, kern = _randn(g, b, h, r, dh, dev=dev), _randn(g, h, 33, dev=dev, scale=0.1)
    gout = _randn(g, b, h, r, dh, dev=dev)
    return q, k, w, v, kern, gout


@pytest.mark.parametrize("b,h,r,c,dh,pad,conv", ATTN_RESIDUAL_SHAPES)
def test_softmax_attn_residuals_kernel(dev, b, h, r, c, dh, pad, conv):
    """The forward's log-sum-exp within 1e-4 absolute of the plain
    version's (fp32 statistics summed in another order; a wrong pad share
    moves it by log(1 + pad e^-m)), o_attn at the output's bar, and the
    backward from those residuals against its plain version fed the same
    residuals, at the backward's bar."""
    q, k, w, v, kern, gout = _attn_inputs(14, b, h, r, c, dh, dev)
    v, kern = (v, kern) if conv else (None, None)
    out, lse, o_attn = _launch_fwd(q, k, w, v, kern, pad, True)
    want_out, want_lse, want_o = softmax_attn_fwd_ref(q, k, w, pad, v, kern)
    _assert_close(out, want_out)
    torch.cuda.synchronize()
    assert lse.shape == want_lse.shape and lse.dtype == torch.float32
    err = (lse - want_lse).abs().max().item()
    assert err <= 1e-4, f"lse max abs error {err}"
    o = o_attn if conv else out
    if conv:
        _assert_close(o_attn, want_o)
    dq, dk, dw, _, _ = _launch_bwd(q, k, w, gout, lse, o, v, kern)
    for name, got, ref in zip(("dq", "dk", "dw"), (dq, dk, dw),
                              softmax_attn_bwd_lse_ref(q, k, w, gout, lse, o)):
        _assert_rel(got, ref.to(got.dtype), name=name)


@pytest.mark.parametrize("b,h,r,c,dh,pad,conv", ATTN_RESIDUAL_SHAPES)
def test_softmax_attn_bwd_kernel_deterministic(dev, b, h, r, c, dh, pad, conv):
    """Two backward runs on the same inputs give the same bits: every sum
    is taken inside one block in a fixed order, with no float atomics."""
    q, k, w, v, kern, gout = _attn_inputs(15, b, h, r, c, dh, dev)
    v, kern = (v, kern) if conv else (None, None)
    _, lse, o_attn = _launch_fwd(q, k, w, v, kern, pad, True)
    o = o_attn if conv else _launch_fwd(q, k, w, v, kern, pad, False)[0]
    first = _launch_bwd(q, k, w, gout, lse, o, v, kern)
    second = _launch_bwd(q, k, w, gout, lse, o, v, kern)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dw", "dv", "dkern"), first, second):
        if a is not None:
            assert torch.equal(a, b_), f"{name} differs between two runs"


def test_softmax_attn_keeps_residuals_only_for_autograd(dev):
    """predict's calls (no grad) write no residuals: the forward returns
    none and the Function saves none."""
    q, k, w, v, kern, _ = _attn_inputs(16, 1, 2, 70, 130, 32, dev)
    with torch.no_grad():
        out = fused_softmax_attn(q, k, w)
    assert out.grad_fn is None
    assert _launch_fwd(q, k, w, v, kern, 0, False)[1:] == (None, None)
    leaf = q.clone().requires_grad_()
    out = fused_softmax_attn(leaf, k, w)
    assert len(out.grad_fn.saved_tensors) == 5  # q, k, w, lse, the output


# (b, H, W, C): also H not a multiple of the backward's 8-row bands, W not
# of its 16-column chunks, C below and not a multiple of its 64-channel
# blocks, and odd C (its element-wise staging)
@pytest.mark.parametrize("b,H,W,C", [(1, 5, 7, 40), (2, 46, 46, 768), (1, 9, 3, 64),
                                     (2, 46, 46, 512), (3, 13, 21, 40), (1, 11, 19, 37)])
def test_ppeg_bwd_kernel(dev, b, H, W, C):
    """Against the plain version, and a second run bit for bit (fixed-order
    sums, no float atomics)."""
    g = torch.Generator().manual_seed(13)
    img = _randn(g, b, H, W, C, dev=dev)
    kern, bias = _randn(g, 7, 7, C, dev=dev, scale=0.1), _randn(g, C, dev=dev, scale=0.1)
    _common.reset_launch_counts()
    (gout,), (dimg, dk, db) = _grads(ppeg_fused, img, kern, bias)
    assert _common.launch_counts() == {"ppeg": 1, "ppeg_bwd": 1}
    ref = ppeg_bwd_ref(img, kern, gout)
    _assert_rel(dimg, ref[0], name="dimg")
    _assert_rel(dk, ref[1].to(dk.dtype), name="dk")
    _assert_rel(db, ref[2].to(db.dtype), name="db")
    _, again = _grads(ppeg_fused, img, kern, bias)
    for name, first, second in zip(("dimg", "dk", "db"), (dimg, dk, db), again):
        assert torch.equal(first, second), name


def test_pinv_gradients_on_the_card(dev):
    """implicit: -z^T (g z^T) from the kernel's z; exact: the backward
    kernel (2b) against its plain version fed the same bf16 inputs, scale
    included, and counted under its own name."""
    g = torch.Generator().manual_seed(14)
    x = torch.softmax(torch.randn(1, 2, 32, 32, generator=g), -1).to(dev, torch.bfloat16)
    xg = x.clone().requires_grad_()
    z = moore_penrose_pinv(xg)
    gz = torch.randn(z.shape, generator=g).to(dev, z.dtype)
    z.backward(gz)
    zt = z.detach().transpose(-1, -2)
    _assert_rel(xg.grad, -(zt @ (gz @ zt)), bound=1e-6, name="dx")
    _common.reset_launch_counts()
    xg = x.clone().requires_grad_()
    moore_penrose_pinv(xg, grad="exact").backward(gz)
    assert _common.launch_counts() == {"moore_penrose_pinv": 1, "moore_penrose_pinv_bwd": 1,
                                       "pinv_gemm": _gemm_launches(6) + _gemm_launches(6, 4)}
    xr = x.clone().requires_grad_()
    s = global_scale(xr)
    gx_ref, gs_ref = pinv_exact_bwd_ref(x, s.detach(), gz, 6)
    # autograd carries gs through the two max() reductions of the scale
    torch.autograd.backward(s, gs_ref)
    _assert_rel(xg.grad, gx_ref + xr.grad.to(gx_ref.dtype), bound=BOUND_PINV_BWD, name="dx")


# Kernel 2b against its plain version on the same bf16 inputs: relative
# Frobenius error of gx and relative error of gs <= 5e-2. The replay chains
# 4 x iters bf16 products and the sweep 8 x iters more; a one-ulp difference
# of an fp32 sum taken in another order rounds a bf16 product to its
# neighbour, and the unconverged iterations carry it on (the plain version
# in bf16 sits 8.6e-3 from the fp32 backward at m 384 on the CPU). Held by
# function too: gx at cosine >= 0.999 of the fp32 autograd of the plain
# iterations (the plain version in bf16 reads 0.99995 there).
BOUND_PINV_BWD, BOUND_PINV_BWD_COS = 5e-2, 0.999


# (b, h, m, iters): small, the slice's (b 16 would only repeat h), m 512
# (--embed_dim 1024, whose stash the TPU needed a wider VMEM limit for), no
# iteration (z0 alone), and m not a multiple of the 64-wide tiles
@pytest.mark.parametrize("b,h,m,iters", [(1, 2, 32, 6), (2, 8, 384, 6), (1, 2, 512, 6),
                                         (1, 2, 384, 0), (1, 1, 100, 6), (2, 8, 256, 6)])
def test_pinv_exact_bwd_kernel(dev, b, h, m, iters):
    g = torch.Generator().manual_seed(15)
    x = torch.softmax(torch.randn(b, h, m, m, generator=g), -1).to(dev, torch.bfloat16)
    gz = _randn(g, b, h, m, m, dev=dev)
    s = global_scale(x)
    _common.reset_launch_counts()
    gx, gs = _pinv_exact_bwd_kernel(x, s, gz, iters)
    want = {"moore_penrose_pinv_bwd": 1, "pinv_gemm": _gemm_launches(iters, 4)}
    assert _common.launch_counts() == {k: v for k, v in want.items() if v}
    assert gx.dtype == torch.bfloat16 and gs.shape == () and gs.dtype == torch.float32
    gx_ref, gs_ref = pinv_exact_bwd_ref(x, s, gz, iters)
    _assert_rel(gx, gx_ref, bound=BOUND_PINV_BWD, name="gx")
    assert abs(gs.item() - gs_ref.item()) <= BOUND_PINV_BWD * abs(gs_ref.item())
    x32 = x.float().requires_grad_()
    pinv_iterations_ref(x32, s, iters).backward(gz.float())
    a, b_ = gx.float().ravel(), x32.grad.ravel()
    assert (a @ b_ / (a.norm() * b_.norm())).item() >= BOUND_PINV_BWD_COS


def test_pinv_exact_bwd_kernel_refuses_fp32(dev):
    """float32 is one of the kernel's types now (test_pinv_instances holds
    it); float64, and a gradient of another type, are refused by name."""
    x = torch.softmax(torch.randn(1, 2, 32, 32, device=dev), -1)
    gx, _ = _pinv_exact_bwd_kernel(x, global_scale(x), torch.ones_like(x), 6)
    assert gx.dtype == torch.float32
    with pytest.raises(TypeError, match="float64"):
        _pinv_exact_bwd_kernel(x.double(), global_scale(x), torch.ones_like(x).double(), 6)
    with pytest.raises(TypeError):
        _pinv_exact_bwd_kernel(x, global_scale(x), torch.ones_like(x).half(), 6)
    with pytest.raises(TypeError, match="float64"):
        moore_penrose_pinv(x.double().requires_grad_(), grad="exact")


# --- the pinv's GEMM alone (csrc/pinv.cu, gemm_mma.cuh) against gemm_ref
# on the same inputs. Bounds: bf16 outputs, rounded once or twice (c, then
# c2 from c) after fp32 sums taken in another order, max abs error <= 1e-2
# of the largest magnitude, as _assert_close; ACC32's fp32 sums <= 1e-5 of
# the largest magnitude (the same bf16 products summed in another order) ---

GEMM_LAYOUTS = {"NN": _NN, "NT": _NT, "TN": _TN}


# m: the slice's, a multiple of 8 but not of the 128-wide tile, not a
# multiple of 8 (element-wise staging), and 512 (--embed_dim 1024)
@pytest.mark.parametrize("epilogue", ["eye", "eye_c2", "add_aliased", "acc32"])
@pytest.mark.parametrize("layout", list(GEMM_LAYOUTS))
@pytest.mark.parametrize("m", [384, 136, 100, 512])
def test_pinv_gemm_kernel(dev, m, layout, epilogue):
    g = torch.Generator().manual_seed(41)
    bh = 3
    a, b = _randn(g, bh, m, m, dev=dev), _randn(g, bh, m, m, dev=dev)
    kw = dict(layout=GEMM_LAYOUTS[layout])
    _common.reset_launch_counts()
    if epilogue == "acc32":
        acc0 = torch.randn(bh, m, m, generator=g).to(dev)
        acc, want = acc0.clone(), acc0.clone()
        _launch_gemm(a, b, acc=acc, epilogue=_ACC32, **kw)
        gemm_ref(a, b, acc=want, epilogue=_ACC32, **kw)
        torch.cuda.synchronize()
        err = (acc - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
        again = acc0.clone()
        _launch_gemm(a, b, acc=again, epilogue=_ACC32, **kw)
        assert torch.equal(acc, again)  # one block a tile: the same bits
    elif epilogue == "add_aliased":
        c = _randn(g, bh, m, m, dev=dev)
        want = c.clone()
        _launch_gemm(a, b, c, prev=c, epilogue=_ADD, c1=-1.0, **kw)
        gemm_ref(a, b, want, prev=want, epilogue=_ADD, c1=-1.0, **kw)
        _assert_close(c, want)
    else:
        c, want = torch.empty_like(a), torch.empty_like(a)
        c2, want2 = (torch.empty_like(a), torch.empty_like(a)) if epilogue == "eye_c2" \
            else (None, None)
        _launch_gemm(a, b, c, c2, epilogue=_EYE, c0=13.0, c1=-0.25, d0=7.0, d1=-1.0, **kw)
        gemm_ref(a, b, want, want2, epilogue=_EYE, c0=13.0, c1=-0.25, d0=7.0, d1=-1.0, **kw)
        _assert_close(c, want)
        if c2 is not None:
            _assert_close(c2, want2)
    assert _common.launch_counts()["pinv_gemm"] >= 1


def test_pinv_exact_bwd_kernel_repeats_bitwise(dev):
    """2b twice on the same inputs: gx (its fp32 ACC32 sum included) and gs
    bit for bit (no split-K, no atomics, fixed-order reductions)."""
    g = torch.Generator().manual_seed(42)
    x = torch.softmax(torch.randn(2, 8, 384, 384, generator=g), -1).to(dev, torch.bfloat16)
    gz = _randn(g, 2, 8, 384, 384, dev=dev)
    s = global_scale(x)
    first = _pinv_exact_bwd_kernel(x, s, gz, 6)
    second = _pinv_exact_bwd_kernel(x, s, gz, 6)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


# --- the ViT half-block kernels of feature extraction (inference only) ---
# Bound: relative Frobenius error <= 1e-2 against the plain version on the
# same bf16 inputs (each output rounded once to bf16 after fp32 sums taken in
# another order; the probabilities, q|k|v and the GELU hidden are rounded
# too, at the same points in both).
BOUND_VIT = 1e-2


def _vit_attn_inputs(g, b, n, heads, dh, dev):
    d = heads * dh
    x = _randn(g, b, n, d, dev=dev)
    ln_s = (1.0 + 0.1 * torch.randn(d, generator=g)).to(dev)
    ln_b = (0.1 * torch.randn(d, generator=g)).to(dev)
    ws = [_randn(g, d, d, dev=dev, scale=d ** -0.5) for _ in range(4)]
    bqkv, bo = (0.1 * torch.randn(3 * d, generator=g)).to(dev), (0.1 * torch.randn(d, generator=g)).to(dev)
    return x, ln_s, ln_b, ws[0], ws[1], ws[2], bqkv, ws[3], bo


# n 197 (Phikon) and odd small n; batch 1 and 3; dh 64 and 32
VIT_SHAPES = [(1, 197, 12, 64), (3, 37, 4, 32), (3, 197, 2, 32), (1, 29, 4, 64)]


@pytest.mark.parametrize("b,n,heads,dh", VIT_SHAPES)
def test_vit_mha_natural_kernel(dev, b, n, heads, dh):
    from mirror_tpu_torch.ops.vit_attn import mha_natural, mha_natural_ref

    g = torch.Generator().manual_seed(20)
    q, k, v = (_randn(g, b, n, heads * dh, dev=dev) for _ in range(3))
    _common.reset_launch_counts()
    out = mha_natural(q, k, v, heads)
    assert _common.launch_counts() == {"vit_mha_natural": 1}
    _assert_rel(out, mha_natural_ref(q, k, v, heads), BOUND_VIT)


@pytest.mark.parametrize("eps", [1e-12, 1e-6])
@pytest.mark.parametrize("b,n,heads,dh", VIT_SHAPES)
def test_vit_attn_block_kernel(dev, b, n, heads, dh, eps):
    from mirror_tpu_torch.ops.vit_attn import attn_block, attn_block_ref

    g = torch.Generator().manual_seed(21)
    args = _vit_attn_inputs(g, b, n, heads, dh, dev)
    _common.reset_launch_counts()
    out = attn_block(*args, heads, eps)
    assert _common.launch_counts() == {"vit_attn_block": 1, "vit_ln": 1, "vit_gemm": 2}
    _assert_rel(out, attn_block_ref(*args, heads, eps), BOUND_VIT)
    # the attention half alone (out - x), where a wrong head or pad shows most
    x = args[0].float()
    _assert_rel(out.float() - x, attn_block_ref(*args, heads, eps).float() - x, 2e-2)


# (b, n, heads, dh) at the kernel's edges: n 256 (the limit: 16 key tiles),
# n 1 and 16 (one query tile), dh 16 and 128, n not a multiple of 16
VIT_EDGE_SHAPES = [(2, 256, 2, 64), (3, 1, 4, 32), (2, 16, 3, 16), (1, 197, 2, 128),
                   (2, 256, 1, 128), (1, 200, 6, 16)]


@pytest.mark.parametrize("b,n,heads,dh", VIT_EDGE_SHAPES)
def test_vit_attention_kernel_edges(dev, b, n, heads, dh):
    """Kernel 8 at its limits through every instance: the natural layout
    (one pair a block), head-major with 3 pairs a block (the double-buffered
    walk where it fits), whole images a block (bit for bit the first), and
    inside attn_block (q, k, v in one q|k|v buffer, ld_in = 3d)."""
    from mirror_tpu_torch.ops.vit_attn import (attn_block, attn_block_ref, mha_headmajor,
                                               mha_headmajor_ref, mha_natural, mha_natural_ref)

    g = torch.Generator().manual_seed(34)
    q, k, v = (_randn(g, b, n, heads * dh, dev=dev) for _ in range(3))
    one = mha_natural(q, k, v, heads)
    _assert_rel(one, mha_natural_ref(q, k, v, heads), BOUND_VIT)
    assert torch.equal(mha_natural(q, k, v, heads, 2), one)
    qz, kz, vz = (t.view(b, n, heads, dh).transpose(1, 2).reshape(b * heads, n, dh).contiguous()
                  for t in (q, k, v))
    hm = mha_headmajor(qz, kz, vz, 3)
    _assert_rel(hm, mha_headmajor_ref(qz, kz, vz), BOUND_VIT)
    assert torch.equal(hm, one.view(b, n, heads, dh).transpose(1, 2).reshape(b * heads, n, dh))
    args = _vit_attn_inputs(g, b, n, heads, dh, dev)
    out = attn_block(*args, heads)
    ref = attn_block_ref(*args, heads)
    x = args[0].float()
    _assert_rel(out.float() - x, ref.float() - x, 2e-2)


@pytest.mark.parametrize("b,n,d,m", [(1, 197, 768, 3072), (3, 37, 64, 256), (3, 23, 128, 512)])
def test_vit_mlp_block_kernel(dev, b, n, d, m):
    from mirror_tpu_torch.ops.vit_attn import mlp_block, mlp_block_ref

    g = torch.Generator().manual_seed(22)
    x = _randn(g, b, n, d, dev=dev)
    ln_s = (1.0 + 0.1 * torch.randn(d, generator=g)).to(dev)
    ln_b = (0.1 * torch.randn(d, generator=g)).to(dev)
    w1, w2 = _randn(g, d, m, dev=dev, scale=d ** -0.5), _randn(g, m, d, dev=dev, scale=m ** -0.5)
    b1, b2 = torch.randn(m, generator=g).to(dev), (0.1 * torch.randn(d, generator=g)).to(dev)
    _common.reset_launch_counts()
    out = mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, 1e-12)
    assert _common.launch_counts() == {"vit_mlp_block": 1, "vit_ln": 1, "vit_gemm": 2}
    ref = mlp_block_ref(x, ln_s, ln_b, w1, b1, w2, b2, 1e-12)
    _assert_rel(out, ref, BOUND_VIT)
    _assert_rel(out.float() - x.float(), ref.float() - x.float(), 2e-2)


def test_vit_kernels_eps_reaches_the_kernel(dev):
    """Rows of variance ~1e-6: eps 1e-6 against 1e-12 moves the LN output by
    ~30 %, so a kernel that dropped eps would miss the plain version."""
    from mirror_tpu_torch.ops.vit_attn import mlp_block, mlp_block_ref

    g = torch.Generator().manual_seed(23)
    d, m = 64, 256
    x = _randn(g, 2, 9, d, dev=dev, scale=1e-3)
    ln_s, ln_b = torch.ones(d, device=dev), torch.zeros(d, device=dev)
    w1, w2 = _randn(g, d, m, dev=dev, scale=d ** -0.5), _randn(g, m, d, dev=dev, scale=m ** -0.5)
    b1, b2 = torch.zeros(m, device=dev), torch.zeros(d, device=dev)
    out = mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, 1e-6)
    _assert_rel(out, mlp_block_ref(x, ln_s, ln_b, w1, b1, w2, b2, 1e-6), BOUND_VIT)
    other = mlp_block_ref(x, ln_s, ln_b, w1, b1, w2, b2, 1e-12)
    assert ((out.float() - other.float()).norm() / other.float().norm()).item() > 0.1


def test_vit_kernels_refuse_bad_inputs(dev):
    from mirror_tpu_torch.ops.vit_attn import attn_block, mha_natural, mlp_block

    g = torch.Generator().manual_seed(24)
    args = list(_vit_attn_inputs(g, 2, 9, 4, 16, dev))
    with pytest.raises(ValueError, match="not divisible"):
        attn_block(*args, heads=5)
    q = args[0]
    with pytest.raises(ValueError, match="not divisible"):
        mha_natural(q, q, q, heads=7)
    # inference only: an input that autograd would track is refused, not
    # detached; under no_grad the same call runs
    xg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        mha_natural(xg, q, q, 4)
    with torch.no_grad():
        mha_natural(xg, q, q, 4)
    with pytest.raises(TypeError):  # dtype
        mha_natural(q.float(), q.float(), q.float(), 4)
    with pytest.raises(TypeError):  # LN scale must be fp32
        attn_block(args[0], args[1].bfloat16(), *args[2:], heads=4)
    with pytest.raises(ValueError):  # shape: wq is [d, d]
        attn_block(*args[:3], args[3][:, :32].contiguous(), *args[4:], heads=4)
    with pytest.raises(ValueError):  # contiguity
        mha_natural(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1), 4)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    misaligned = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        mha_natural(misaligned, q, q, 4)
    long = _randn(g, 1, 300, 64, dev=dev)
    with pytest.raises(ValueError, match="at most"):
        mha_natural(long, long, long, 4)
    w1 = _randn(g, 64, 256, dev=dev)
    with pytest.raises(ValueError):  # mixed devices
        mlp_block(q, args[1], args[2], w1.cpu(), torch.zeros(256, device=dev), w1.t().contiguous(),
                  torch.zeros(64, device=dev))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_vit_kernel_path_matches_cpu_plain_path(dev, quant):
    """A small ViTB16 (image 64, patch 16: 17 tokens; hidden 128, 4 heads of
    32, depth 2) on the card's kernels in bf16 against the CPU's plain path
    in fp32, same weights: cosine >= 0.99 per image (bf16 drift; a wrong
    head, pad or rounding point moves it by O(1))."""
    from mirror_tpu_torch.models.feature_extractors import ViTB16, init_weights

    kw = dict(image_size=64, patch_size=16, hidden_size=128, depth=2, num_heads=4, quant=quant)
    cpu = init_weights(ViTB16(**kw).eval(), torch.Generator().manual_seed(30))
    gpu = ViTB16(**kw, dtype=torch.bfloat16).to(dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(31))
    _common.reset_launch_counts()
    with torch.no_grad():
        got = gpu(x.to(dev)).float().cpu()
        want = cpu(x)
    expect = {"vit_mha_natural": 2} if quant else {"vit_attn_block": 2, "vit_mlp_block": 2,
                                                    "vit_ln": 4, "vit_gemm": 8}
    assert _common.launch_counts() == expect
    cos = (got * want).sum(-1) / (got.norm(dim=-1) * want.norm(dim=-1))
    assert (cos >= 0.99).all(), cos


# --- the ViT projection GEMM (csrc/vit_gemm.cu, wgmma fed by TMA) and its LN
# pass, alone

# The GEMM against a float64 product with the float64 epilogue: a bf16
# output within 2^-7 of the reference's largest magnitude (one bf16 ulp is
# 2^-8 relative; the fp32 sum of K products adds its own rounding). M 111 =
# 3 x 37 (a ragged row tile); N below, at and past the 256-column tile and
# not a multiple of it (64, 192, 2304 = 9 x 256 is one; 768, 3072 are); B
# drawn without symmetry, so an operand read transposed shows.
BOUND_VIT_GEMM = 2.0 ** -7


@pytest.mark.parametrize("k", [64, 768, 3072])
@pytest.mark.parametrize("n", [64, 192, 768, 2304, 3072])
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_vit_gemm_kernel(dev, epilogue, n, k):
    from mirror_tpu_torch.ops import vit_attn as va

    g = torch.Generator().manual_seed(40)
    m = 3 * 37
    a = _randn(g, 3, 37, k, dev=dev)
    w = _randn(g, k, n, dev=dev, scale=k ** -0.5) + 0.05 * torch.arange(
        n, device=dev, dtype=torch.float32).div(n).to(torch.bfloat16)
    bias = torch.randn(n, generator=g).to(dev)
    resid = _randn(g, 3, 37, n, dev=dev)
    epi = {"bias": va._EPI_BIAS, "gelu": va._EPI_BIAS_GELU,
           "residual": va._EPI_BIAS_RESIDUAL}[epilogue]
    out = torch.full((3, 37, n), float("nan"), dtype=torch.bfloat16, device=dev)
    _common.reset_launch_counts()
    va._launch_gemm(a, w, bias, out, epi, resid=resid if epilogue == "residual" else None)
    assert _common.launch_counts() == {"vit_gemm": 1}
    ref = a.double().reshape(m, k) @ w.double() + bias.double()
    if epilogue == "gelu":
        ref = 0.5 * ref * (1.0 + torch.erf(ref * 2.0 ** -0.5))
    if epilogue == "residual":
        ref = resid.double().reshape(m, n) + ref
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = (out.double().reshape(m, n) - ref).abs().max().item()
    assert err <= BOUND_VIT_GEMM * ref.abs().max().item(), err
    # and against its plain version (the same fp32 sum, other order)
    plain = torch.empty_like(out)
    va.gemm_ref(a, w, bias, plain, epi, resid=resid)
    _assert_close(out, plain, BOUND_VIT_GEMM)


# The LN pass against _ln_ref on the card: both take fp32 statistics, but
# their sums run in other orders (the kernel a warp a row, torch's reduction
# its own), so mu and rstd can differ in the last fp32 bit, and a y that
# lies that close to a bf16 rounding boundary rounds the other way (a y near
# 0, where (x - mu) s and b cancel, by a few of its own small ulps). So:
# every y within one bf16 ulp of the largest magnitude (2^-8 of it), and at
# most 1e-3 of them not bit for bit _ln_ref's; a wrong statistic or affine
# moves almost every element by far more.
@pytest.mark.parametrize("rows,d", [(111, 768), (5, 64), (37, 1000), (9, 2048), (3, 4096)])
def test_vit_ln_kernel(dev, rows, d):
    from mirror_tpu_torch.ops import vit_attn as va

    g = torch.Generator().manual_seed(41)
    x = _randn(g, rows, d, dev=dev) + 0.5
    s = (1.0 + 0.1 * torch.randn(d, generator=g)).to(dev)
    b = (0.1 * torch.randn(d, generator=g)).to(dev)
    y = torch.empty_like(x)
    _common.reset_launch_counts()
    va._launch_ln(x, s, b, 1e-12, y)
    assert _common.launch_counts() == {"vit_ln": 1}
    ref = va._ln_ref(x, s, b, 1e-12)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs()
    assert err.max().item() <= 2.0 ** -8 * ref.float().abs().max().item()
    assert (y != ref).count_nonzero().item() <= 1e-3 * y.numel()
    y2 = torch.empty_like(x)
    va._launch_ln(x, s, b, 1e-12, y2)
    assert torch.equal(y, y2)


def test_vit_ln_refuses_wide_rows(dev):
    from mirror_tpu_torch.ops.vit_attn import mlp_block

    d = 4104
    x = torch.zeros(1, 2, d, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(d, 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="at most"):
        mlp_block(x, torch.ones(d, device=dev), torch.zeros(d, device=dev), w,
                  torch.zeros(8, device=dev), w.t().contiguous(), torch.zeros(d, device=dev))


def test_vit_half_blocks_same_bits_twice(dev):
    """Kernels 6 and 7 at a Phikon-like width run twice give the same bits:
    every sum has a fixed order (no atomics, no split K)."""
    from mirror_tpu_torch.ops.vit_attn import attn_block, mlp_block

    g = torch.Generator().manual_seed(42)
    args = _vit_attn_inputs(g, 3, 197, 12, 64, dev)
    assert torch.equal(attn_block(*args, 12), attn_block(*args, 12))
    x, ln_s, ln_b = args[:3]
    w1, w2 = _randn(g, 768, 3072, dev=dev, scale=768 ** -0.5), _randn(g, 3072, 768, dev=dev,
                                                                    scale=3072 ** -0.5)
    b1, b2 = torch.randn(3072, generator=g).to(dev), torch.randn(768, generator=g).to(dev)
    assert torch.equal(mlp_block(x, ln_s, ln_b, w1, b1, w2, b2),
                       mlp_block(x, ln_s, ln_b, w1, b1, w2, b2))


def _assert_max_rel(out, ref, name=""):
    """Max abs error within 1e-2 (a bf16 output) or 1e-4 (fp32) of the
    reference's largest magnitude."""
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.isfinite(out.float()).all(), name
    bound = (1e-2 if out.dtype == torch.bfloat16 else 1e-4) * ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= bound, f"{name}: max abs error {err} > {bound}"


# (b, h, n, d, K): a short last step (140 rows = 2 x 64 + 12), n <= K // 2,
# the self-test's shape, d 8 with K 7, K 65 at d 128, and kernel 4b's conv at
# the padded length r 2304
@pytest.mark.parametrize("taps_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,n,d,ksize", [(2, 3, 140, 32, 33), (1, 2, 10, 16, 33),
                                           (8, 8, 2117, 96, 33), (2, 2, 300, 8, 7),
                                           (1, 2, 200, 128, 65), (2, 8, 2304, 96, 33)])
def test_conv1d_kernel(dev, b, h, n, d, ksize, taps_dtype):
    g = torch.Generator().manual_seed(20)
    v = _randn(g, b, h, n, d, dev=dev)
    kern = (torch.randn(h, ksize, generator=g) * 0.1).to(dev, taps_dtype)
    _common.reset_launch_counts()
    taps = kern.to(torch.bfloat16)
    _assert_close(depthwise_conv1d_seq(v, kern), depthwise_conv_seq_ref(v, taps).to(v.dtype))
    (gout,), (dv, dkern) = _grads(depthwise_conv1d_seq, v, kern)
    assert _common.launch_counts() == {"conv1d": 2, "conv1d_bwd": 1}
    assert (dv.dtype, dkern.dtype) == (v.dtype, taps_dtype)
    dv_ref, dkern_ref = depthwise_conv_seq_bwd_ref(v, taps, gout)
    _assert_rel(dv, dv_ref, name="dv")
    _assert_max_rel(dkern, dkern_ref, name="dkern")


# (b, n, d, heads, dh): the slice's x [2, 2117, 768] with 8 heads of 96;
# h dh != d (4 heads of 40 at d 64); ragged rows and columns; d 8; phase 3's
# x [16, 2117, 768]; the TMA-box epilogue with a last column tile of one
# head (3 h dh = 288) and n not a multiple of the 128-row tile; the general
# instance with 3 h dh = 336, not a multiple of the 192-column tile
@pytest.mark.parametrize("b,n,d,heads,dh", [(2, 2117, 768, 8, 96), (3, 37, 64, 4, 40),
                                            (1, 5, 8, 1, 8), (2, 300, 256, 2, 24),
                                            (16, 2117, 768, 8, 96), (3, 200, 128, 1, 96),
                                            (2, 129, 128, 2, 56)])
def test_ln_qkv_kernel(dev, b, n, d, heads, dh):
    g = torch.Generator().manual_seed(21)
    x = _randn(g, b, n, d, dev=dev)
    s = (1.0 + 0.1 * torch.randn(d, generator=g)).to(dev)
    lb = (0.1 * torch.randn(d, generator=g)).to(dev)
    w = _randn(g, d, 3 * heads * dh, dev=dev, scale=d ** -0.5)
    _common.reset_launch_counts()
    for o, r in zip(ln_qkv_fused(x, s, lb, w, heads), ln_qkv_ref(x, s, lb, w, heads)):
        assert o.shape == (b, heads, n, dh)
        _assert_close(o, r)
    gouts, (gx, gs, gb, gw) = _grads(lambda *a: ln_qkv_fused(*a, heads), x, s, lb, w)
    assert _common.launch_counts() == {"ln_qkv": 2, "ln_qkv_bwd": 1}
    assert (gx.dtype, gw.dtype, gs.dtype, gb.dtype) == (x.dtype, w.dtype, s.dtype, lb.dtype)
    gx_ref, gw_ref, gs_ref, gb_ref = ln_qkv_bwd_ref(x, s, lb, w, *gouts, heads)
    _assert_rel(gx, gx_ref, name="gx")
    for name, got, ref in (("gw", gw, gw_ref), ("gs", gs, gs_ref), ("gb", gb, gb_ref)):
        _assert_max_rel(got, ref, name=name)


def test_ln_qkv_wgmma_transposed_operands(dev):
    """One tile of each wgmma form that only kernel 10b issues, against
    torch.matmul: gy = G w^T reads w's rows K-major (transpose-B 0), gw =
    y^T G reads y MN-major (transpose-A 1); operands drawn without symmetry,
    so an operand read the other way shows."""
    from mirror_tpu_torch.ops import ln_qkv as lq

    g = torch.Generator().manual_seed(23)
    G, w = _randn(g, 128, 64, dev=dev), _randn(g, 256, 64, dev=dev)  # one 128 x 256 tile, K 64
    gy = torch.empty(128, 256, dtype=torch.float32, device=dev)
    lq._launch_grad_y(G, w, gy)
    _assert_max_rel(gy, G.float() @ w.float().t(), name="gy")
    y, G2 = _randn(g, 64, 128, dev=dev), _randn(g, 64, 256, dev=dev)  # d 128, 3 h dh 256
    gw = torch.empty(128, 256, dtype=torch.bfloat16, device=dev)
    lq._launch_grad_w(y, G2, gw, 1)
    _assert_max_rel(gw, (y.float().t() @ G2.float()).to(torch.bfloat16), name="gw")


def test_conv1d_and_ln_qkv_backward_repeat_bitwise(dev):
    """The batch sums (dkern; gw, gs, gb) are reduced in a fixed order with
    no atomics: two backward passes on the same inputs agree bit for bit."""
    g = torch.Generator().manual_seed(22)
    v = _randn(g, 4, 8, 2117, 96, dev=dev)
    kern = (0.1 * torch.randn(8, 33, generator=g)).to(dev)
    x = _randn(g, 2, 2117, 256, dev=dev)
    s, lb = torch.ones(256, device=dev), torch.zeros(256, device=dev)
    w = _randn(g, 256, 3 * 4 * 32, dev=dev, scale=256 ** -0.5)
    for fn, inputs in ((depthwise_conv1d_seq, (v, kern)),
                       (lambda *a: ln_qkv_fused(*a, 4), (x, s, lb, w))):
        first, second = (_grads(fn, *inputs)[1] for _ in range(2))
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_conv1d_and_ln_qkv_refuse_bad_inputs(dev):
    x = torch.zeros(1, 2, 20, 12, device=dev, dtype=torch.bfloat16)
    # d 12, not a multiple of 8: the forward takes any d, its backward (9b) not
    out = depthwise_conv1d_seq(x.clone().requires_grad_(), x.new_zeros(2, 33))
    assert out.shape == x.shape and not out.float().abs().sum().item()
    with pytest.raises(ValueError, match="9b"):
        out.float().sum().backward()
    with pytest.raises(ValueError):  # an even number of taps
        depthwise_conv1d_seq(x[..., :8].contiguous(), x.new_zeros(2, 32))
    y = torch.zeros(1, 5, 64, device=dev, dtype=torch.bfloat16)
    s, lb = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(TypeError):  # the kernel takes bf16 x and w
        ln_qkv_fused(y.float(), s, lb, y.new_zeros(64, 96).float(), 2)
    with pytest.raises(ValueError):  # dh 12
        ln_qkv_fused(y, s, lb, y.new_zeros(64, 72), 2)


# --- the kernels of the TPU probes (mirror_tpu_torch/scripts) ---


# (b, h, n, d, gb, tile): gb 8 / 4 / 1 / the whole batch, gb not dividing b,
# n not a multiple of the 384-row tile, d 96 and 128; runs shorter than one
# 48 KB stage (80 bytes, one 16-byte row) and of several stages with a
# ragged last piece
@pytest.mark.parametrize("b,h,n,d,gb,tile", [(5, 3, 777, 96, 2, None), (3, 2, 100, 128, 8, None),
                                             (4, 8, 2304, 96, 4, None), (7, 2, 770, 96, 1, 384),
                                             (9, 3, 1000, 128, 8, 384), (6, 2, 50, 96, 6, None),
                                             (3, 2, 5, 8, 2, None), (2, 2, 1, 8, 1, None),
                                             (2, 1, 3000, 96, 1, 1000)])
def test_copy_floor_kernel_bit_exact(dev, b, h, n, d, gb, tile):
    from mirror_tpu_torch.ops.copy_floor import copy_floor

    g = torch.Generator().manual_seed(30)
    x = _randn(g, b, h, n, d, dev=dev)
    _common.reset_launch_counts()
    out = copy_floor(x, gb, tile)
    torch.cuda.synchronize()
    assert _common.launch_counts() == {"copy_floor": 1}
    assert torch.equal(out, x)


def test_copy_floor_kernel_refuses_a_misaligned_view(dev):
    """Bulk copies move 16-byte units from 16-byte addresses: a view 2
    bytes into its storage is refused, not copied some other way."""
    from mirror_tpu_torch.ops.copy_floor import copy_floor

    base = torch.zeros(2 * 2 * 16 * 8 + 1, dtype=torch.bfloat16, device=dev)
    x = base[1:].view(2, 2, 16, 8)
    assert x.is_contiguous() and x.data_ptr() % 16
    _common.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        copy_floor(x, 1)
    assert _common.launch_counts() == {}


@pytest.mark.parametrize("b,h,n,d,ksize", [(2, 3, 140, 32, 33), (8, 8, 2304, 96, 33),
                                           (2, 2, 300, 8, 7), (1, 2, 10, 16, 33),
                                           (1, 2, 200, 128, 65)])
def test_conv1d_bwd_dv_only_and_column_sum(dev, b, h, n, d, ksize):
    """dv alone is the fused backward's dv bit for bit; the column sum
    alone, on the fused pass's partials, is its dkern bit for bit."""
    from mirror_tpu_torch.ops import conv1d

    g = torch.Generator().manual_seed(31)
    v, gr = _randn(g, b, h, n, d, dev=dev), _randn(g, b, h, n, d, dev=dev)
    taps = _randn(g, h, ksize, dev=dev, scale=0.1)
    dv, dkern = torch.empty_like(v), torch.empty(h, ksize, device=dev)
    partial = conv1d.conv1d_bwd_scratch(v, ksize)
    conv1d.conv1d_bwd_into(v, taps, gr, dv, dkern, partial)
    _common.reset_launch_counts()
    dv_only = conv1d.conv1d_bwd_dv(gr, taps)
    col = conv1d.column_sum(partial)
    torch.cuda.synchronize()
    assert _common.launch_counts() == {"conv1d_bwd_dv": 1, "column_sum": 1}
    assert torch.equal(dv_only, dv)
    assert torch.equal(col, dkern.reshape(-1))
    _assert_rel(dv_only, conv1d.conv1d_bwd_dv_ref(gr, taps), BOUND_BWD)


def test_conv1d_dkern_batch_sum_bar_at_phase3(dev):
    """dkern at [16, 8, 2117, 96], K 33 (chip_smoke.py phase 3's shape): the
    tensor cores' fp32 sums over 3.3 million products a tap hold the batch
    sum's bar, 1e-4 of its largest magnitude, and dv its 2e-2; the scratch
    holds one partial a (batch, chunk), as conv_plan tiles the rows."""
    from mirror_tpu_torch.ops import conv1d

    g = torch.Generator().manual_seed(33)
    v, gr = _randn(g, 16, 8, 2117, 96, dev=dev), _randn(g, 16, 8, 2117, 96, dev=dev)
    taps = _randn(g, 8, 33, dev=dev, scale=0.1)
    partial = conv1d.conv1d_bwd_scratch(v, 33)
    assert tuple(partial.shape) == (16 * conv1d.conv_plan(128, 2117)[1], 8 * 33)
    dv, dkern = torch.empty_like(v), torch.empty(8, 33, device=dev)
    conv1d.conv1d_bwd_into(v, taps, gr, dv, dkern, partial)
    dv_ref, dkern_ref = depthwise_conv_seq_bwd_ref(v, taps, gr)
    _assert_rel(dv, dv_ref, BOUND_BWD, name="dv")
    _assert_max_rel(dkern, dkern_ref, name="dkern")


# (nparts, count): the call sites' tall and wide shapes ([1152, 264] and
# [288, 264] the former conv partials, [96, 38400] kernel 5b's), counts not
# a multiple of 4 (the scalar path), one part, and a view 4 bytes into its
# storage (not 16-byte aligned: the scalar path too)
@pytest.mark.parametrize("nparts,count,offset", [(1152, 264, 0), (288, 264, 0), (96, 38400, 0),
                                                 (288, 99, 0), (1, 99, 0), (7, 4099, 0),
                                                 (64, 264, 1)])
def test_column_sum_kernel(dev, nparts, count, offset):
    """The column sum against the float64 sum (within 1e-6 of each column's
    sum of magnitudes) and against ``partial.sum(0)``; bit for bit its
    order's plain emulation (``column_sum_in_order``, so the host's copy of
    the group rule is the kernel's) and itself over two runs."""
    from mirror_tpu_torch.ops import conv1d

    g = torch.Generator().manual_seed(34)
    flat = torch.randn(nparts * count + offset, generator=g).to(dev)
    parts = flat[offset:].view(nparts, count)
    out = torch.empty(count, device=dev)
    _common.launch("mirror_column_sum", parts.data_ptr(), nparts, count, out.data_ptr())
    again = torch.empty_like(out)
    _common.launch("mirror_column_sum", parts.data_ptr(), nparts, count, again.data_ptr())
    torch.cuda.synchronize()
    want = parts.double().sum(0)
    scale = parts.double().abs().sum(0)
    assert ((out.double() - want).abs() <= 1e-6 * scale).all()
    assert ((parts.sum(0).double() - want).abs() <= 1e-6 * scale).all()
    assert torch.equal(out, again)
    assert torch.equal(out, conv1d.column_sum_in_order(parts))


# (b, n, heads, dh, group): G pairs a block dividing b h or not, at Phikon's
# n and at small odd n
@pytest.mark.parametrize("b,n,heads,dh,group", [(2, 197, 12, 64, 8), (3, 37, 4, 32, 5),
                                                (1, 197, 12, 64, 32), (2, 29, 4, 64, 1)])
def test_vit_mha_headmajor_kernel(dev, b, n, heads, dh, group):
    from mirror_tpu_torch.ops.vit_attn import mha_headmajor, mha_headmajor_ref

    g = torch.Generator().manual_seed(32)
    q, k, v = (_randn(g, b * heads, n, dh, dev=dev) for _ in range(3))
    _common.reset_launch_counts()
    out = mha_headmajor(q, k, v, group)
    assert _common.launch_counts() == {"vit_mha_headmajor": 1}
    _assert_rel(out, mha_headmajor_ref(q, k, v), BOUND_VIT)


@pytest.mark.parametrize("images", [1, 2, 3, 8])
def test_vit_mha_natural_images_per_block(dev, images):
    """N whole images a block against the plain version, and bit for bit
    kernel 8's one (image, head) pair a block (the same arithmetic per
    pair)."""
    from mirror_tpu_torch.ops.vit_attn import mha_natural, mha_natural_ref

    g = torch.Generator().manual_seed(33)
    b, n, heads, dh = 5, 197, 12, 64
    q, k, v = (_randn(g, b, n, heads * dh, dev=dev) for _ in range(3))
    _common.reset_launch_counts()
    one = mha_natural(q, k, v, heads)
    assert _common.launch_counts() == {"vit_mha_natural": 1}
    _common.reset_launch_counts()
    out = mha_natural(q, k, v, heads, images)
    assert _common.launch_counts() == {"vit_mha_natural_grouped": 1}
    _assert_rel(out, mha_natural_ref(q, k, v, heads), BOUND_VIT)
    assert torch.equal(out, one)


@pytest.mark.parametrize("stash", [1, 2])
def test_pinv_exact_bwd_stash_variants(dev, stash):
    """The backward that keeps z (and x z) and recomputes the rest with the
    replay's own launches: kernel 2b's gradient, within 2b's bars against
    its plain version, and bit for bit against 2b itself."""
    g = torch.Generator().manual_seed(34)
    x = torch.softmax(torch.randn(2, 2, 384, 384, generator=g), -1).to(dev, torch.bfloat16)
    gz = _randn(g, 2, 2, 384, 384, dev=dev)
    s = global_scale(x)
    full = _pinv_exact_bwd_kernel(x, s, gz, 6)
    _common.reset_launch_counts()
    gx, gs = _pinv_exact_bwd_kernel(x, s, gz, 6, stash)
    assert _common.launch_counts() == {f"moore_penrose_pinv_bwd_stash{stash}": 1,
                                       "pinv_gemm": _gemm_launches(6, stash)}
    gx_ref, gs_ref = pinv_exact_bwd_ref(x, s, gz, 6)
    _assert_rel(gx, gx_ref, bound=BOUND_PINV_BWD, name="gx")
    assert abs(gs.item() - gs_ref.item()) <= BOUND_PINV_BWD * abs(gs_ref.item())
    assert torch.equal(gx, full[0]) and torch.equal(gs, full[1])


# --- the fused ViT sub-layers of the probe exp_vit_fused_sublayer (k5, k7,
# k8, k9), inference only. Bound: BOUND_VIT on the output, and for k8 and
# k9 on out - x too (x passes through and dominates the output) ---


def _fused_inputs(g, b, n, d, m, dev):
    x = _randn(g, b, n, d, dev=dev)
    ln_s = (1.0 + 0.1 * torch.randn(d, generator=g)).to(dev)
    ln_b = (0.1 * torch.randn(d, generator=g)).to(dev)
    wqkv = _randn(g, d, 3 * d, dev=dev, scale=d ** -0.5)
    wo = _randn(g, d, d, dev=dev, scale=d ** -0.5)
    bqkv, bo = (0.1 * torch.randn(3 * d, generator=g)).to(dev), (0.1 * torch.randn(d, generator=g)).to(dev)
    w1, w2 = _randn(g, d, m, dev=dev, scale=d ** -0.5), _randn(g, m, d, dev=dev, scale=m ** -0.5)
    b1, b2 = torch.randn(m, generator=g).to(dev), (0.1 * torch.randn(d, generator=g)).to(dev)
    return x, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2, b2


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("n", [197, 50])
@pytest.mark.parametrize("kernel", ["k5", "k7", "k8", "k9"])
def test_vit_fused_sublayer_kernel(dev, kernel, n, group):
    from mirror_tpu_torch.ops import vit_fused as vf

    g = torch.Generator().manual_seed(40)
    b, heads, d, m = 3, 12, 768, 3072
    x, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2, b2 = _fused_inputs(g, b, n, d, m, dev)
    calls = {
        "k5": (vf.KERNEL_ATTN, lambda: vf.fused_attn(x, wqkv, bqkv, wo, bo, heads, group),
               lambda: vf.fused_attn_ref(x, wqkv, bqkv, wo, bo, heads)),
        "k7": (vf.KERNEL_MLP, lambda: vf.fused_mlp(x, w1, b1, w2, b2, group),
               lambda: vf.fused_mlp_ref(x, w1, b1, w2, b2)),
        "k8": (vf.KERNEL_ATTN_BLOCK,
               lambda: vf.fused_attn_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, 1e-12, group),
               lambda: vf.fused_attn_block_ref(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, 1e-12)),
        "k9": (vf.KERNEL_MLP_BLOCK,
               lambda: vf.fused_mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, 1e-12, group),
               lambda: vf.fused_mlp_block_ref(x, ln_s, ln_b, w1, b1, w2, b2, 1e-12)),
    }
    name, kernel_call, plain = calls[kernel]
    _common.reset_launch_counts()
    out = kernel_call()
    assert _common.launch_counts() == {name: 1}
    ref = plain()
    _assert_rel(out, ref, BOUND_VIT, name)
    if kernel in ("k8", "k9"):
        _assert_rel(out.float() - x.float(), ref.float() - x.float(), BOUND_VIT, f"{name} out - x")


# (heads, d, n, group, the heads a CTA the kernel takes at that shape): the
# probe's 12 heads of 64 (two a CTA, 6-CTA clusters) at n 197, 50 and 1 and
# G 1, 2 and 4; dh 128 (6 heads of d 768: one a CTA) at n 50, 1 and 176, the
# most its shared memory takes; odd head counts (3 heads of 128, d 384; 9
# heads of 64, d 576, a non-portable 9-CTA cluster: one a CTA); clusters of
# one CTA (2 heads of 64, 1 head of 64)
FUSED_ATTN_CASES = [(12, 768, 197, 1, 2), (12, 768, 197, 2, 2), (12, 768, 197, 4, 2),
                    (12, 768, 50, 2, 2), (12, 768, 50, 1, 2), (12, 768, 1, 4, 2),
                    (12, 768, 1, 1, 2), (6, 768, 50, 1, 1), (6, 768, 1, 2, 1),
                    (6, 768, 176, 1, 1), (3, 384, 176, 1, 1), (3, 384, 50, 2, 1),
                    (9, 576, 197, 1, 1), (9, 576, 50, 2, 1), (2, 128, 197, 1, 2),
                    (1, 64, 50, 2, 1)]


@pytest.mark.parametrize("kernel", ["k5", "k8"])
@pytest.mark.parametrize("heads,d,n,group,hpc", FUSED_ATTN_CASES)
def test_vit_fused_attn_kernel_instances(dev, kernel, heads, d, n, group, hpc):
    """Each CTA mapping of the fused attention, reached by shape, against
    the plain version, one launch a call; k8 also on out - x."""
    from mirror_tpu_torch.ops import vit_fused as vf

    assert vf.heads_per_cta(n, d // heads, heads) == hpc
    g = torch.Generator().manual_seed(42)
    x, ln_s, ln_b, wqkv, bqkv, wo, bo = _fused_inputs(g, 5, n, d, 8, dev)[:7]
    _common.reset_launch_counts()
    if kernel == "k5":
        out = vf.fused_attn(x, wqkv, bqkv, wo, bo, heads, group)
        ref = vf.fused_attn_ref(x, wqkv, bqkv, wo, bo, heads)
        name = vf.KERNEL_ATTN
    else:
        out = vf.fused_attn_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, 1e-12, group)
        ref = vf.fused_attn_block_ref(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, 1e-12)
        name = vf.KERNEL_ATTN_BLOCK
    assert _common.launch_counts() == {name: 1}
    _assert_rel(out, ref, BOUND_VIT, f"{kernel} {heads}x{d // heads} n {n} G {group} hpc {hpc}")
    if kernel == "k8":
        _assert_rel(out.float() - x.float(), ref.float() - x.float(), BOUND_VIT, "k8 out - x")


@pytest.mark.parametrize("heads,d", [(12, 768), (9, 576)])  # two heads a CTA; one
def test_vit_fused_attn_same_bits_twice(dev, heads, d):
    """The out product sums heads in a fixed order with no atomics: two
    calls of k5 and of k8 give the same bits."""
    from mirror_tpu_torch.ops import vit_fused as vf

    g = torch.Generator().manual_seed(43)
    x, ln_s, ln_b, wqkv, bqkv, wo, bo = _fused_inputs(g, 9, 197, d, 8, dev)[:7]
    for call in (lambda: vf.fused_attn(x, wqkv, bqkv, wo, bo, heads, 1),
                 lambda: vf.fused_attn_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, 1e-12,
                                             2)):
        first = call()
        assert torch.equal(call(), first)


# (b, n, d, m, group): the fused MLP (k7, k9) at row counts that are not a
# multiple of its 64-row tiles nor of a cluster's (b 3 at n 197: 591 rows;
# b 5 at n 50; b 7 at n 1), G 1 and 2, an MLP width that is not a multiple
# of its 128-column hidden chunks (1000: a last chunk of 104 columns, the
# second of its 2 boxes partial; 520: 8 columns, 1 box, and an odd number of
# chunks for the two fc1 CTAs), and d 384 (the second fc2 CTA computes no
# column)
FUSED_MLP_CASES = [(3, 197, 768, 3072, 1), (3, 197, 768, 3072, 2), (5, 50, 768, 3072, 1),
                   (5, 50, 768, 3072, 2), (7, 1, 768, 3072, 1), (7, 1, 768, 3072, 2),
                   (3, 197, 768, 1000, 1), (3, 197, 768, 520, 2), (3, 197, 384, 1536, 1),
                   (5, 50, 384, 1000, 2)]


@pytest.mark.parametrize("kernel", ["k7", "k9"])
@pytest.mark.parametrize("b,n,d,m,group", FUSED_MLP_CASES)
def test_vit_fused_mlp_kernel_instances(dev, kernel, b, n, d, m, group):
    """The fused MLP at ragged shapes against the plain version, one launch
    a call; k9 also on out - x."""
    from mirror_tpu_torch.ops import vit_fused as vf

    g = torch.Generator().manual_seed(44)
    x, ln_s, ln_b, _, _, _, _, w1, b1, w2, b2 = _fused_inputs(g, b, n, d, m, dev)
    _common.reset_launch_counts()
    if kernel == "k7":
        out = vf.fused_mlp(x, w1, b1, w2, b2, group)
        ref = vf.fused_mlp_ref(x, w1, b1, w2, b2)
        name = vf.KERNEL_MLP
    else:
        out = vf.fused_mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, 1e-12, group)
        ref = vf.fused_mlp_block_ref(x, ln_s, ln_b, w1, b1, w2, b2, 1e-12)
        name = vf.KERNEL_MLP_BLOCK
    assert _common.launch_counts() == {name: 1}
    _assert_rel(out, ref, BOUND_VIT, f"{kernel} b {b} n {n} d {d} m {m} G {group}")
    if kernel == "k9":
        _assert_rel(out.float() - x.float(), ref.float() - x.float(), BOUND_VIT, "k9 out - x")


@pytest.mark.parametrize("n,d,m", [(197, 768, 3072), (50, 384, 1000)])
def test_vit_fused_mlp_same_bits_twice(dev, n, d, m):
    """The hidden chunks are summed in a fixed order with no atomics: two
    calls of k7 and of k9 give the same bits, and so does G 2."""
    from mirror_tpu_torch.ops import vit_fused as vf

    g = torch.Generator().manual_seed(45)
    x, ln_s, ln_b, _, _, _, _, w1, b1, w2, b2 = _fused_inputs(g, 9, n, d, m, dev)
    for ln, kernel in ((None, vf.KERNEL_MLP), ((ln_s, ln_b), vf.KERNEL_MLP_BLOCK)):
        first = vf._mlp(x, ln, w1, b1, w2, b2, 1e-12, 1, kernel)
        assert torch.equal(vf._mlp(x, ln, w1, b1, w2, b2, 1e-12, 1, kernel), first)
        assert torch.equal(vf._mlp(x, ln, w1, b1, w2, b2, 1e-12, 2, kernel), first)


def test_vit_fused_sublayer_kernels_refuse_bad_inputs(dev):
    from mirror_tpu_torch.ops import vit_fused as vf

    g = torch.Generator().manual_seed(41)
    x, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2, b2 = _fused_inputs(g, 2, 20, 768, 256, dev)
    with pytest.raises(TypeError, match="bfloat16"):  # fp32
        vf.fused_attn(x.float(), wqkv, bqkv, wo, bo, 12)
    with pytest.raises(TypeError, match="bfloat16"):
        vf.fused_mlp_block(x.float(), ln_s, ln_b, w1, b1, w2, b2)
    long = _randn(g, 1, 300, 768, dev=dev)
    for call in (lambda: vf.fused_attn(long, wqkv, bqkv, wo, bo, 12),
                 lambda: vf.fused_attn_block(long, ln_s, ln_b, wqkv, bqkv, wo, bo, 12)):
        with pytest.raises(ValueError, match="at most 256"):  # n > 256
            call()
    with pytest.raises(ValueError, match="head dim 192"):  # dh 192
        vf.fused_attn_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, 4)
    with pytest.raises(ValueError, match="at most 16"):  # 24 heads of 32: no such cluster
        vf.fused_attn(x, wqkv, bqkv, wo, bo, 24)
    with pytest.raises(ValueError, match="shared memory"):  # dh 128 at n 197: 251 KB a CTA
        vf.fused_attn(_randn(g, 1, 197, 768, dev=dev), wqkv, bqkv, wo, bo, 6)
    wide = _randn(g, 2, 20, 1024, dev=dev)
    with pytest.raises(ValueError, match="at most 768"):
        vf.fused_mlp(wide, _randn(g, 1024, 256, dev=dev), b1, _randn(g, 256, 1024, dev=dev),
                     torch.zeros(1024, device=dev))
    xg = x.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        vf.fused_mlp(xg, w1, b1, w2, b2)
    with torch.no_grad():
        vf.fused_mlp(xg, w1, b1, w2, b2)


# --- the CLIP baseline's path: the dual encoder and the optimizer side ---

DUAL_KW = dict(wsi_embed_dim=64, rna_embed_dim=100, embed_dim=384, rna_encoder_depth=1,
               rna_proj_drop_rate=0.0, wsi_dropout=0.0, pinv_grad="implicit",
               dtype="bfloat16")


def test_dual_encoder_on_the_card_matches_its_plain_path(dev):
    """mirror_dual at embed 384 (8 heads of 48, 192 landmarks; 300 tokens:
    325 rows, pad 59), bf16: the card's kernels against the CPU's plain
    path on the same weights. The embeddings within a relative Frobenius
    error of 5e-2 and the InfoNCE loss within 2e-2 (chip_smoke's bars for
    two Nystrom layers in bf16), the kernel-fed gradients at cosine >= 0.99;
    one forward and backward launch two of each Nystrom kernel and one of
    PPEG and its backward."""
    from mirror_tpu_torch.losses import info_nce
    from mirror_tpu_torch.registry import create_model

    g = torch.Generator().manual_seed(3)
    wsi, rna = torch.randn(3, 300, 64, generator=g), torch.randn(3, 100, generator=g)
    results = {}
    state = None
    for device in ("cuda", "cpu"):
        model = create_model("mirror_dual", device=device,
                             generator=None if state else torch.Generator().manual_seed(0),
                             **DUAL_KW)
        if state is None:
            state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        _common.reset_launch_counts()
        w, r = model(wsi.to(device), rna.to(device))
        loss = info_nce(w, r, symmetric=True)
        loss.backward()
        launches = _common.launch_counts()
        grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                 if "to_qkv" in n or "res_conv" in n or "pos_layer" in n}
        results[device] = (w.detach().float().cpu(), r.detach().float().cpu(),
                           float(loss.detach()), grads, launches)
    (wc, rc, lc, gc, launches), (wp, rp, lp, gp, _) = results["cuda"], results["cpu"]
    for out, ref in ((wc, wp), (rc, rp)):
        assert ((out - ref).norm() / ref.norm()).item() <= 5e-2
    assert abs(lc - lp) <= 2e-2 * abs(lp)
    for name in gp:
        cos = (gc[name].ravel() @ gp[name].ravel()
               / (gc[name].norm() * gp[name].norm())).item()
        assert cos >= 0.99, f"{name}: cosine {cos}"
    for name in ("landmark_softmax", "moore_penrose_pinv", "softmax_attn", "softmax_attn_conv",
                 "landmark_softmax_bwd", "softmax_attn_bwd", "softmax_attn_conv_bwd"):
        assert launches.get(name) == 2, (name, launches)
    assert launches.get("ppeg") == 1 and launches.get("ppeg_bwd") == 1, launches


@pytest.mark.parametrize("opt,clip_mode", [("lamb", "agc"), ("adamw", "norm"), ("adam", "agc"),
                                           ("rmsprop", "value"), ("adagrad", "norm")])
def test_optimizer_side_on_the_card_matches_the_cpu(dev, opt, clip_mode):
    """ChainOptimizer's batched _foreach updates, its device-side clip and
    trust ratio, with accumulation 2 and the EMA, on CUDA tensors against
    the same run on the CPU: every parameter and EMA weight within 1e-5 of
    its scale after 6 micro-steps."""
    from types import SimpleNamespace

    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import ModelEma

    args = SimpleNamespace(opt=opt, opt_eps=None, opt_betas=None, opt_kwargs={},
                           momentum=0.9, weight_decay=0.05, clip_grad=0.5,
                           clip_mode=clip_mode, layer_decay=None, use_sched=True,
                           sched="cosine", sched_on_updates=True, grad_accum_steps=2, epochs=3,
                           warmup_epochs=1, decay_epochs=1, decay_milestones=(1,),
                           warmup_lr=1e-4, min_lr=0.0, decay_rate=0.1, warmup_prefix=False,
                           lr_cycle_mul=1.0, lr_cycle_decay=0.5, lr_cycle_limit=1,
                           lr_k_decay=1.0, cooldown_epochs=0, lr_noise=None, seed=0)
    g = torch.Generator().manual_seed(5)
    init = {"enc.weight": torch.randn(64, 48, generator=g),
            "enc.bias": torch.randn(64, generator=g),
            "head.weight": torch.randn(3, 64, generator=g)}
    grads = [{k: 3 * torch.randn(v.shape, generator=g) for k, v in init.items()}
             for _ in range(6)]
    out = {}
    for device in ("cuda", "cpu"):
        model = torch.nn.Module()
        model.enc = torch.nn.Linear(48, 64)
        model.head = torch.nn.Linear(64, 3, bias=False)
        model.load_state_dict(init)
        model.to(device)
        opt_ = make_optimizer(args, model, 1e-2, steps_per_epoch=2)
        ema = ModelEma(model, 0.9, warmup=True)
        for step in grads:
            for name, p in model.named_parameters():
                p.grad = step[name].to(device)
            if opt_.step():
                ema.update()
        out[device] = ({k: v.detach().cpu() for k, v in model.state_dict().items()},
                       {k: v.cpu() for k, v in ema.module.state_dict().items()})
    for got, want in zip(out["cuda"], out["cpu"]):
        for key in want:
            scale = want[key].abs().max().item()
            assert (got[key] - want[key]).abs().max().item() <= 1e-5 * scale, key


# --------------------------------------------------------------------------
# context parallelism (parallel/context_parallel.py) on one card
# --------------------------------------------------------------------------

# (h, m, c, dh, parts): the whole-slide path's landmarks against a rank's
# columns (the 40,000-patch slide's 40320 rows over 2 ranks), and a ragged
# one split in 3
CP_KV_SHAPES = [(8, 384, 20160, 96, 2), (2, 16, 150, 32, 3)]


@pytest.mark.parametrize("h,m,c,dh,parts", CP_KV_SHAPES)
def test_cp_kv_combine_kernel_matches_its_plain_version(dev, h, m, c, dh, parts):
    """The context-parallel r3 = softmax(q_l k^T) v: KvCombine without a
    group (kernel 3, then kernel 3c from its residuals) against its plain
    version on the same inputs, forward and backward, one launch each; and
    over ``parts`` column blocks as the ranks run it: kernel 3 on each block
    keeping its row lse, the parts combined (lse_g = logsumexp of the
    blocks' lse, r3 = sum exp(lse_r - lse_g) o_r in fp32, one rounding),
    then kernel 3c on each block given the global lse and r3: dk and dv of
    each block and dq summed over the blocks against the plain backward
    over all columns (the bars of the attention's tests)."""
    from mirror_tpu_torch.parallel.context_parallel import KvCombine

    g = torch.Generator().manual_seed(21)
    q_l = _randn(g, 1, h, m, dh, dev=dev, scale=dh ** -0.5)
    k, v = _randn(g, 1, h, c, dh, dev=dev), _randn(g, 1, h, c, dh, dev=dev)
    _common.reset_launch_counts()
    (gout,), grads = _grads(lambda *t: KvCombine.apply(*t, True), q_l, k, v)
    assert _common.launch_counts() == {"softmax_attn": 1, "softmax_attn_bwd": 1}
    want = softmax_attn_ref(q_l, k, v).to(q_l.dtype)
    with torch.no_grad():
        _assert_close(KvCombine.apply(q_l, k, v, True), want)
    for name, got, ref in zip(("dq_l", "dk", "dv"), grads,
                              softmax_attn_bwd_ref(q_l, k, v, gout)):
        _assert_rel(got, ref.to(got.dtype), name=name)

    cols = [c * i // parts for i in range(parts + 1)]
    blocks = [(k[:, :, a:b].contiguous(), v[:, :, a:b].contiguous())
              for a, b in zip(cols, cols[1:])]
    fwd = [_launch_fwd(q_l, kb, vb, None, None, 0, keep=True)[:2] for kb, vb in blocks]
    lse_g = torch.logsumexp(torch.stack([lse for _, lse in fwd]), dim=0)
    r3 = sum(torch.exp(lse - lse_g).unsqueeze(-1) * o.float() for o, lse in fwd).to(q_l.dtype)
    _assert_close(r3, want)
    bwd = [_launch_bwd(q_l, kb, vb, gout, lse_g, r3, None, None)[:3] for kb, vb in blocks]
    dq = sum(d[0].float() for d in bwd)
    ref = softmax_attn_bwd_ref(q_l, k, v, gout)
    _assert_rel(dq, ref[0], name="dq_l summed")
    _assert_rel(torch.cat([d[1] for d in bwd], 2), ref[1].to(q_l.dtype), name="dk")
    _assert_rel(torch.cat([d[2] for d in bwd], 2), ref[2].to(q_l.dtype), name="dv")


@pytest.mark.parametrize("n,parts", [(4608, 2), (4608, 4), (100, 4)])
def test_conv1d_kernel_on_halo_extended_blocks(dev, n, parts):
    """Kernel 9 on each rank's block extended by 16 rows of its neighbours
    (zeros at the ends of the sequence), its middle rows kept, against the
    conv of the whole sequence: the context-parallel residual conv. n 100
    over 4: blocks of 25 rows, just over the halo."""
    h, dh, ksize = 8, 96, 33
    halo = ksize // 2
    g = torch.Generator().manual_seed(22)
    v = _randn(g, 1, h, n, dh, dev=dev)
    kern = _randn(g, h, ksize, dev=dev, scale=0.1)
    want = depthwise_conv1d_seq(v, kern)
    padded = torch.nn.functional.pad(v, (0, 0, halo, halo))
    size = n // parts
    got = torch.cat([depthwise_conv1d_seq(padded[:, :, r * size:(r + 1) * size + 2 * halo]
                                          .contiguous(), kern)[:, :, halo:halo + size]
                     for r in range(parts)], dim=2)
    _assert_close(got, want)
    _assert_close(want, depthwise_conv_seq_ref(v, kern).to(v.dtype))


def test_exported_classifier_on_the_card_launches_its_ops(dev, tmp_path):
    """The classifier at embed 384 (the dual encoder's widths), exported on
    the card: its graph calls the five ``mirror::`` forward ops, and the
    ``.pt2`` after save and load launches each kernel as the eager model
    does (two Nystrom layers: 2 each of kernels 1-4, 1 of PPEG) and gives
    the eager model's output bit for bit (the same kernels on the same
    inputs)."""
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.tools.export_model import mirror_ops

    kw = {k: v for k, v in DUAL_KW.items() if k not in ("pinv_grad",)}
    model = create_model("mirror_classifier", device="cuda", num_classes=3,
                         generator=torch.Generator().manual_seed(0), **kw)
    g = torch.Generator().manual_seed(4)
    wsi, rna = torch.randn(2, 300, 64, generator=g).cuda(), torch.randn(2, 100, generator=g).cuda()
    with torch.no_grad():
        program = torch.export.export(model, (wsi, rna))
        assert mirror_ops(program) == ["mirror::landmark_softmax", "mirror::pinv",
                                       "mirror::ppeg", "mirror::softmax_attn",
                                       "mirror::softmax_attn_conv"]
        torch.export.save(program, str(tmp_path / "clf.pt2"))
        loaded = torch.export.load(str(tmp_path / "clf.pt2")).module()
        _common.reset_launch_counts()
        eager = model(wsi, rna)
        eager_launches = _common.launch_counts()
        _common.reset_launch_counts()
        out = loaded(wsi, rna)
        launches = _common.launch_counts()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert launches == eager_launches
    for name in ("landmark_softmax", "moore_penrose_pinv", "softmax_attn", "softmax_attn_conv"):
        assert launches.get(name) == 2, (name, launches)
    assert launches.get("ppeg") == 1, launches


# --- the float32 and float16 instances of kernels 1-5 and 9 (the compute
# types of --no-amp and --amp-dtype float16), each against its plain version
# on the same inputs in the same type. Bars, as relative Frobenius errors:
# float16 rounds where bf16 does with a finer ulp (2^-11 against 2^-8), so
# it takes bf16's bars (1e-2 forward, 2e-2 backward); float32 rounds
# nowhere but the products' 3xTF32 split (about 2^-21 relative a product),
# the sums' order and ex2.approx (2 ulp), so 1e-4 forward and 1e-3 backward
# (dsim = P dP - P D cancels, and dq, dk sum such terms). The pinv is held
# by function as in bf16, and in float32 also at 1e-3.
INSTANCE_DTYPES = [torch.float32, torch.float16]
INSTANCE_BARS = {torch.float32: (1e-4, 1e-3), torch.float16: (1e-2, 2e-2)}


def _name(dtype):
    return str(dtype).split(".")[-1]


@pytest.mark.parametrize("dtype", INSTANCE_DTYPES, ids=_name)
@pytest.mark.parametrize("b,h,n,dh,m", [(1, 2, 45, 16, 8), (2, 8, 2117, 96, 384),
                                        (1, 2, 70, 48, 40), (1, 2, 300, 128, 64)])
def test_landmark_softmax_instances(dev, dtype, b, h, n, dh, m):
    fwd_bar, bwd_bar = INSTANCE_BARS[dtype]
    g = torch.Generator().manual_seed(30)
    q = _randn(g, b, h, n, dh, dev=dev, dtype=dtype, scale=dh ** -0.5)
    k = _randn(g, b, h, n, dh, dev=dev, dtype=dtype)
    pad = (m - n % m) % m
    _common.reset_launch_counts()
    out = landmark.landmark_softmax_op(q, k, m, pad)
    assert _common.launch_counts() == {f"landmark_softmax[{_name(dtype)}]": 1}
    ref = landmark.landmark_softmax_lse_ref(q, k, m, pad)
    for name, got, want in zip(("q_l", "k_l", "attn2", "lse"), out, ref):
        assert got.dtype == want.dtype, name
        _assert_rel(got, want, bound=fwd_bar, name=name)
    grads = [_randn(g, b, h, m, dh, dev=dev, dtype=dtype),
             _randn(g, b, h, m, dh, dev=dev, dtype=dtype),
             _randn(g, b, h, m, m, dev=dev, dtype=dtype)]
    q_l, k_l, _, lse = ref
    got = landmark._launch_bwd(q_l, k_l, lse, n, pad, *grads)
    want = landmark.landmark_softmax_bwd_lse_ref(q_l, k_l, lse, n, pad, *grads)
    for name, a, r in zip(("dq", "dk"), got, want):
        assert a.dtype == dtype, name
        _assert_rel(a, r, bound=bwd_bar, name=name)


@pytest.mark.parametrize("dtype", INSTANCE_DTYPES, ids=_name)
@pytest.mark.parametrize("b,h,r,c,dh,pad,conv", [
    (1, 2, 8, 40, 16, 24, False), (2, 3, 70, 130, 32, 0, False),
    (2, 8, 384, 2117, 96, 187, False), (2, 8, 2117, 384, 96, 0, False),
    (1, 2, 10, 8, 16, 0, True), (2, 8, 2117, 384, 96, 0, True), (1, 2, 300, 64, 128, 0, True)])
def test_softmax_attn_instances(dev, dtype, b, h, r, c, dh, pad, conv):
    """Kernels 3, 3b, 4 and their backwards 3c, 4b (its conv: 9b's) in one
    type: the forward with its residuals, then the backward from the plain
    version's residuals."""
    fwd_bar, bwd_bar = INSTANCE_BARS[dtype]
    g = torch.Generator().manual_seed(31)
    q = _randn(g, b, h, r, dh, dev=dev, dtype=dtype, scale=dh ** -0.5)
    k, w = (_randn(g, b, h, c, dh, dev=dev, dtype=dtype) for _ in range(2))
    v = _randn(g, b, h, r, dh, dev=dev, dtype=dtype) if conv else None
    kern = _randn(g, h, 33, dev=dev, dtype=dtype, scale=0.1) if conv else None
    out, lse, o_attn = _launch_fwd(q, k, w, v, kern, pad, keep=True)
    ref_out, ref_lse, ref_o = softmax_attn_fwd_ref(q, k, w, pad, v, kern)
    _assert_rel(out, ref_out, bound=fwd_bar, name="out")
    _assert_rel(lse, ref_lse, bound=fwd_bar, name="lse")
    if conv:
        _assert_rel(o_attn, ref_o, bound=fwd_bar, name="o_attn")
    gout = _randn(g, b, h, r, dh, dev=dev, dtype=dtype)
    got = _launch_bwd(q, k, w, gout, ref_lse, ref_o, v, kern)
    want = [t.to(dtype) for t in softmax_attn_bwd_lse_ref(q, k, w, gout, ref_lse, ref_o)]
    if conv:
        dv, dkern = depthwise_conv_seq_bwd_ref(v, kern, gout)
        want += [dv.to(dtype), dkern]
    for name, a, ref in zip(("dq", "dk", "dw", "dv", "dkern"), got, want):
        _assert_rel(a, ref, bound=bwd_bar, name=name)


@pytest.mark.parametrize("dtype", INSTANCE_DTYPES, ids=_name)
@pytest.mark.parametrize("b,h,m", [(1, 2, 32), (2, 8, 384), (1, 2, 100)])
def test_pinv_instances(dev, dtype, b, h, m):
    """Kernel 2 held by function (|x z - I| no worse than 1.5x the plain
    version's, or 0.05) and, in float32, at 1e-3 of it; kernel 2b at the
    bf16 instance's bars against its plain version."""
    g = torch.Generator().manual_seed(32)
    x = torch.softmax(torch.randn(b, h, m, m, generator=g), -1).to(dev, dtype)
    s = global_scale(x)
    _common.reset_launch_counts()
    z = moore_penrose_pinv(x)
    assert _common.launch_counts() == {f"moore_penrose_pinv[{_name(dtype)}]": 1,
                                       f"pinv_gemm[{_name(dtype)}]": _gemm_launches(6)}
    z_ref = pinv_iterations_ref(x, s)
    eye = torch.eye(m, device=dev)
    err = (x.float() @ z.float() - eye).abs().max().item()
    err_ref = (x.float() @ z_ref.float() - eye).abs().max().item()
    assert err <= max(1.5 * err_ref, 0.05), (err, err_ref)
    if dtype == torch.float32:
        _assert_rel(z, z_ref, bound=1e-3, name="z")
    gz = torch.randn(b, h, m, m, generator=g).to(dev, dtype)
    gx, gs = _pinv_exact_bwd_kernel(x, s, gz, 6)
    gx_ref, gs_ref = pinv_exact_bwd_ref(x, s, gz, 6)
    assert gx.dtype == dtype
    _assert_rel(gx, gx_ref, bound=BOUND_PINV_BWD, name="gx")
    assert abs(gs.item() - gs_ref.item()) <= BOUND_PINV_BWD * abs(gs_ref.item())


@pytest.mark.parametrize("dtype", INSTANCE_DTYPES, ids=_name)
@pytest.mark.parametrize("b,H,W,C", [(2, 46, 46, 768), (1, 5, 7, 32), (1, 9, 9, 20)])
def test_ppeg_instances(dev, dtype, b, H, W, C):
    fwd_bar, bwd_bar = INSTANCE_BARS[dtype]
    g = torch.Generator().manual_seed(33)
    img = _randn(g, b, H, W, C, dev=dev, dtype=dtype)
    kern = _randn(g, 7, 7, C, dev=dev, dtype=dtype, scale=0.1)
    bias = _randn(g, C, dev=dev, dtype=dtype, scale=0.1)
    _common.reset_launch_counts()
    (gout,), grads = _grads(ppeg_fused, img, kern, bias)
    assert _common.launch_counts() == {f"ppeg[{_name(dtype)}]": 1,
                                       f"ppeg_bwd[{_name(dtype)}]": 1}
    _assert_rel(ppeg_fused(img, kern, bias), ppeg_ref(img, kern, bias), bound=fwd_bar,
                name="out")
    dimg, dk, db = ppeg_bwd_ref(img, kern, gout)
    for name, a, ref in zip(("dimg", "dk", "db"), grads, (dimg, dk.to(dtype), db.to(dtype))):
        assert a.dtype == dtype, name
        _assert_rel(a, ref, bound=bwd_bar, name=name)


@pytest.mark.parametrize("dtype", INSTANCE_DTYPES, ids=_name)
@pytest.mark.parametrize("b,h,n,d,ksize", [(2, 8, 2117, 96, 33), (1, 2, 40, 8, 7),
                                           (1, 2, 300, 128, 33), (1, 2, 130, 104, 65),
                                           (1, 3, 10, 16, 33)])
def test_conv1d_instances(dev, dtype, b, h, n, d, ksize):
    """Kernels 9 and 9b: d 104 and 128 take the float32 backward's two
    feature parts (its two rings of d columns would not fit a block)."""
    fwd_bar, bwd_bar = INSTANCE_BARS[dtype]
    g = torch.Generator().manual_seed(34)
    v = _randn(g, b, h, n, d, dev=dev, dtype=dtype)
    kern = _randn(g, h, ksize, dev=dev, dtype=dtype, scale=0.1)
    _common.reset_launch_counts()
    (gout,), (dv, dkern) = _grads(depthwise_conv1d_seq, v, kern)
    assert _common.launch_counts() == {f"conv1d[{_name(dtype)}]": 1,
                                       f"conv1d_bwd[{_name(dtype)}]": 1}
    _assert_rel(depthwise_conv1d_seq(v, kern), depthwise_conv_seq_ref(v, kern).to(dtype),
                bound=fwd_bar, name="out")
    dv_ref, dkern_ref = depthwise_conv_seq_bwd_ref(v, kern, gout)
    _assert_rel(dv, dv_ref.to(dtype), bound=bwd_bar, name="dv")
    _assert_rel(dkern, dkern_ref.to(dtype), bound=bwd_bar, name="dkern")


def test_instances_refuse_what_the_kernels_do_not_take(dev):
    """float64, and operands of two types, are refused by name; nothing
    falls back to a plain version."""
    x = torch.randn(1, 2, 45, 16, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        landmark.landmark_softmax_op(x, x, 8, 3)
    y = torch.randn(1, 5, 7, 32, device=dev)
    with pytest.raises(TypeError, match="float32"):
        ppeg_fused(y, y.new_zeros(7, 7, 32).half(), y.new_zeros(32))
    q = torch.randn(1, 2, 8, 16, device=dev)
    with pytest.raises(TypeError, match="float16"):
        _launch_fwd(q, q.half(), q, None, None, 0, keep=False)


# --- every width the JAX package serves: the forward kernels 1, 3, 3b, 4, 9
# at any head dim and landmark count ---

WIDTH_DTYPES = [torch.bfloat16, torch.float16, torch.float32]
WIDTH_BARS = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-4}
WIDTH_N = {12: 50, 396: 700, 768: 800}  # pads 10, 92, 736


@pytest.mark.parametrize("dtype", WIDTH_DTYPES, ids=_name)
@pytest.mark.parametrize("m", [12, 396, 768])
@pytest.mark.parametrize("dh", [6, 24, 99, 136, 192, 256, 320])
def test_forward_kernels_at_every_width(dev, dh, m, dtype):
    """Ragged head dims (6, 24, 99: zero-filled columns, element loads and
    stores where a row is not a whole number of 16-byte pieces), head dims
    above 128 (the output's dh split over 128-column blocks), landmark counts
    not a multiple of 8: kernels 1, 3 (with its pad and lse), 3b, 4 (with
    lse and o_attn) and 9, each launched once, against their plain
    versions in the same type, at the instances' forward bars."""
    bar = WIDTH_BARS[dtype]
    n, b, h = WIDTH_N[m], 1, 2
    pad = (m - n % m) % m
    g = torch.Generator().manual_seed(dh + m)
    q = _randn(g, b, h, n, dh, dev=dev, dtype=dtype, scale=dh ** -0.5)
    k, v = (_randn(g, b, h, n, dh, dev=dev, dtype=dtype) for _ in range(2))
    w = _randn(g, b, h, m, dh, dev=dev, dtype=dtype)
    kern = _randn(g, h, 33, dev=dev, dtype=dtype, scale=33 ** -0.5)
    _common.reset_launch_counts()
    got = landmark.landmark_softmax_op(q, k, m, pad)
    assert _common.launch_counts() == {_common.instance("landmark_softmax", dtype): 1}
    ref = landmark.landmark_softmax_lse_ref(q, k, m, pad)
    for name, a, r in zip(("q_l", "k_l", "attn2", "lse"), got, ref):
        _assert_rel(a, r, bound=bar, name=name)
    q_l, k_l = ref[0], ref[1]
    for name, args, pad_c in (("kv", (q_l, k, v, None, None), pad),
                              ("q", (q, k_l, w, None, None), 0),
                              ("conv", (q, k_l, w, v, kern), 0)):
        out, lse, o_attn = _launch_fwd(*args, pad_c, keep=True)
        ref_out, ref_lse, ref_o = softmax_attn_fwd_ref(*args[:3], pad_c, *args[3:])
        _assert_rel(out, ref_out, bound=bar, name=f"{name} out")
        _assert_rel(lse, ref_lse, bound=bar, name=f"{name} lse")
        if o_attn is not None:
            _assert_rel(o_attn, ref_o, bound=bar, name=f"{name} o_attn")
        # without the residuals (serving): the same output
        assert torch.equal(_launch_fwd(*args, pad_c, keep=False)[0], out), name
    _common.reset_launch_counts()
    conv = depthwise_conv1d_seq(v, kern)
    assert _common.launch_counts() == {_common.instance("conv1d", dtype): 1}
    _assert_rel(conv, depthwise_conv_seq_ref(v, kern).to(dtype), bound=bar, name="conv")
