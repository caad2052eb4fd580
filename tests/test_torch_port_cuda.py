"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (sm_90a) and nvcc; without one they skip.
They import neither jax nor the JAX package, so they also run where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Inputs are bf16, the kernels' type. Bounds, with their reasons:
- outputs rounded once to bf16 after an fp32 sum taken in another order
  (landmark means and softmax, attention, PPEG): max abs error <= 1e-2 of
  the reference's largest magnitude (a bf16 ulp is 2^-8 = 3.9e-3 relative;
  the attention also rounds its probabilities before the product);
- the pinv, whose 6 iterations amplify one-ulp differences of 24 chained
  bf16 products: held by function, |x z - I| no worse than 1.5x the plain
  version's (or 0.05), as the JAX package's bf16 pinv test holds it;
- the backward kernels, against their plain versions fed the same bf16
  inputs and incoming gradient: relative Frobenius error <= 2e-2 per
  output. Each output is rounded once to bf16 (2^-9 relative), but dsim is
  rounded too before its products, and a probability that the kernel and
  the plain version compute one fp32 ulp apart can round dsim to the next
  bf16 value; dk and dq are sums of such terms with cancellation.
"""

import pytest
import torch

from mirror_tpu_torch.ops import _common
from mirror_tpu_torch.ops.landmark import (
    landmark_softmax,
    landmark_softmax_bwd_ref,
    landmark_softmax_ref,
)
from mirror_tpu_torch.ops.nystrom_attn import (
    depthwise_conv_seq_bwd_ref,
    depthwise_conv_seq_ref,
    fused_softmax_attn,
    fused_softmax_attn_conv,
    softmax_attn_bwd_ref,
    softmax_attn_ref,
)
from mirror_tpu_torch.ops.pinv import global_scale, moore_penrose_pinv, pinv_iterations_ref
from mirror_tpu_torch.ops.ppeg import ppeg_bwd_ref, ppeg_fused, ppeg_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, *shape, dev, scale=1.0):
    x = torch.randn(*shape, generator=gen) * scale
    return x.to(device=dev, dtype=torch.bfloat16)


def _assert_close(out, ref, rel=1e-2):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    bound = rel * ref.float().abs().max().item()
    assert err <= bound, f"max abs error {err} > {bound}"


@pytest.mark.parametrize("b,h,n,dh,m", [(1, 2, 20, 16, 8), (1, 2, 45, 16, 8),
                                        (2, 8, 2117, 96, 384), (2, 8, 2049, 96, 384)])
def test_landmark_softmax_kernel(dev, b, h, n, dh, m):
    g = torch.Generator().manual_seed(0)
    q, k = _randn(g, b, h, n, dh, dev=dev), _randn(g, b, h, n, dh, dev=dev)
    pad = (m - n % m) % m
    for o, r in zip(landmark_softmax(q, k, m, pad), landmark_softmax_ref(q, k, m, pad)):
        _assert_close(o, r)


@pytest.mark.parametrize("b,h,m", [(1, 2, 32), (2, 8, 384), (1, 1, 100)])
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
                                            (1, 8, 384, 2049, 96, 255)])
def test_softmax_attn_kernel(dev, b, h, r, c, dh, pad):
    g = torch.Generator().manual_seed(2)
    q = _randn(g, b, h, r, dh, dev=dev, scale=dh ** -0.5)
    k, w = _randn(g, b, h, c, dh, dev=dev), _randn(g, b, h, c, dh, dev=dev)
    out = fused_softmax_attn(q, k, w, pad)
    _assert_close(out, softmax_attn_ref(q, k, w, pad).to(q.dtype))


@pytest.mark.parametrize("b,h,n,m,dh", [(1, 2, 10, 8, 16), (2, 3, 70, 16, 32),
                                        (1, 8, 2117, 384, 96), (1, 8, 2049, 384, 96)])
def test_softmax_attn_conv_kernel(dev, b, h, n, m, dh):
    g = torch.Generator().manual_seed(3)
    q = _randn(g, b, h, n, dh, dev=dev, scale=dh ** -0.5)
    v = _randn(g, b, h, n, dh, dev=dev)
    k_l, w = _randn(g, b, h, m, dh, dev=dev), _randn(g, b, h, m, dh, dev=dev)
    kern = _randn(g, h, 33, dev=dev, scale=0.1)
    out = fused_softmax_attn_conv(q, k_l, w, v, kern)
    ref = softmax_attn_ref(q, k_l, w) + depthwise_conv_seq_ref(v, kern)
    _assert_close(out, ref.to(q.dtype))


@pytest.mark.parametrize("b,H,W,C", [(1, 5, 7, 40), (2, 46, 46, 768)])
def test_ppeg_kernel(dev, b, H, W, C):
    g = torch.Generator().manual_seed(4)
    img = _randn(g, b, H, W, C, dev=dev)
    kern, bias = _randn(g, 7, 7, C, dev=dev, scale=0.1), _randn(g, C, dev=dev, scale=0.1)
    _assert_close(ppeg_fused(img, kern, bias), ppeg_ref(img, kern, bias))


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


# (b, h, n, dh, m): pad 4 (group 0 all pad), pad 3, and the slice's two
# Nystrom shapes: the encoder (2117 rows, pad 187: groups 0-30 all pad) and
# the retention decoder (2049 rows, pad 255: groups 0-41 all pad)
@pytest.mark.parametrize("b,h,n,dh,m", [(1, 2, 20, 16, 8), (1, 2, 45, 16, 8),
                                        (2, 8, 2117, 96, 384), (2, 8, 2049, 96, 384)])
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


@pytest.mark.parametrize("b,h,r,c,dh,pad", [(1, 2, 8, 40, 16, 24), (2, 3, 70, 130, 32, 0),
                                            (2, 8, 384, 2117, 96, 187),
                                            (2, 8, 384, 2049, 96, 255)])
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
                                        (2, 8, 2117, 384, 96), (2, 8, 2049, 384, 96)])
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


@pytest.mark.parametrize("b,H,W,C", [(1, 5, 7, 40), (2, 46, 46, 768), (1, 9, 3, 64)])
def test_ppeg_bwd_kernel(dev, b, H, W, C):
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


def test_pinv_gradients_on_the_card(dev):
    """implicit: -z^T (g z^T) from the kernel's z; exact: refused, it needs
    the exact backward kernel (2b), which is not ported."""
    g = torch.Generator().manual_seed(14)
    x = torch.softmax(torch.randn(1, 2, 32, 32, generator=g), -1).to(dev, torch.bfloat16)
    xg = x.clone().requires_grad_()
    z = moore_penrose_pinv(xg)
    gz = torch.randn(z.shape, generator=g).to(dev, z.dtype)
    z.backward(gz)
    zt = z.detach().transpose(-1, -2)
    _assert_rel(xg.grad, -(zt @ (gz @ zt)), bound=1e-6, name="dx")
    with pytest.raises(NotImplementedError, match="2b"):
        moore_penrose_pinv(x.clone().requires_grad_(), grad="exact")
