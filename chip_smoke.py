#!/usr/bin/env python3
"""Drive the PyTorch port of MIRROR once on one NVIDIA card, and check it.

    python3 chip_smoke.py            # from the repo root; one CUDA card, nvcc

Phases, each printed as it finishes:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of ``mirror_tpu_torch/csrc`` compiled from the
   checkout's sources, with its build time;
3. kernels: each forward kernel against its plain PyTorch version on the
   card, at the shapes the slices give it (batch 16, 8 heads, dh 96, 384
   landmarks; the encoder's 2117 rows with front pad 187 and the retention
   decoder's 2049 rows with pad 255; the pad-0 q variant at its own shapes;
   PPEG on [16, 46, 46, 768]; the ViT half-blocks and the natural-layout
   attention at Phikon's batch of 256: x [256, 197, 768], 12 heads, MLP
   3072, eps 1e-12), bf16: max abs error, relative
   Frobenius error, the bound, the median time of kernel, plain version and
   (where one PyTorch call computes the same function) that call;
3b. backward kernels: each against its plain version fed the same inputs
   and incoming gradient, at the train slice's shapes (the encoder's 2117
   rows with pad 187 and the retention decoder's 2049 rows with pad 255;
   PPEG on [16, 46, 46, 768]), error per output, and the same times;
4. serving slice: a full-width ``mirror_classifier`` (the subtyping
   configuration: 768-d Phikon features, embed 768, RNA 10234, 2048 tokens,
   bf16) with random weights from a seeded generator, saved as a reference
   ``.pth.tar``; 48 synthetic slides scored by
   ``mirror_tpu_torch.tools.predict.predict`` with batch 16, every kernel's
   launch count read around that run, the CSV checked, and two slides
   re-scored on the CPU by the plain path as the reference;
5. train slice: a synthetic pretrain cohort (64 slides, a 10234-gene RNA
   CSV, a fold-0 split) trained for one epoch of 4 steps at batch 16 by
   ``mirror_tpu_torch.train_mirror.main`` with the pretrain template
   (full width, bf16, Adam 2e-5, implicit pinv gradient), launch counts
   read around it, every logged loss finite, the ``--result`` JSON printed,
   the saved ``.pth.tar`` reloaded; then the median ms per train step and
   the peak device memory on one resident batch, a ``torch.profiler`` split
   of one step by kernel, and one step at batch 2 on the card against the
   CPU's plain path (loss and the gradients that only the backward kernels
   feed);
6. feature extraction: 8 synthetic slides of 2,048 224x224 JPEG patches in
   all (``{root}/{class}/{slide}/``), run through
   ``mirror_tpu_torch.tools.gen_patch_feature.main`` three times at batch
   256 on the card (``--model phikon``, ``--model phikon --quant int8``,
   ``--model custom_resnet50``; random weights from a seed), launch counts
   read around each run (12 of each half-block kernel per Phikon batch, 12
   attention launches per int8 batch), every file [n, 768] or [n, 1024] and
   finite, patches/s on the host clock; then each backbone's median ms on
   one resident uint8 batch of 256, Phikon's peak device memory and a
   ``torch.profiler`` split of its batch; then 8 patches on the card against
   the CPU's plain path in fp32 (cosine), and int8 against bf16 (cosine).

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
The script imports nothing of JAX.
"""

import json
import logging
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0

# the slices' shapes (configs/subtyping/ and configs/pretrain/mirror.template.yaml)
B, HEADS, DH, M = 16, 8, 96, 384
N_TOKENS = 2048
SIDE = 46  # ceil(sqrt(2048)): 2116 grid tokens
N = SIDE * SIDE + 1  # + cls: 2117 rows into each encoder Nystrom attention
PAD = (M - N % M) % M  # 187 front-pad rows, never built
N_DEC = N_TOKENS + 1  # 2049 rows into the retention decoder's attention
PAD_DEC = (M - N_DEC % M) % M  # 255
EMBED, RNA_DIM, CONV_TAPS = 768, 10234, 33
MODEL_KWARGS = dict(
    wsi_embed_dim=768, rna_embed_dim=RNA_DIM, embed_dim=EMBED, rna_encoder_depth=2,
    rna_gene_embed="learn", rna_mlp_ratio=4.0, rna_pos_drop_rate=0.0,
    rna_proj_drop_rate=0.1, rna_attn_drop_rate=0.0, rna_drop_path_rate=0.0,
    rna_norm_layer="layernorm", rna_act_layer="gelu", fusion="concat",
)
N_SLIDES = 48
PRETRAIN_YAML = REPO / "configs" / "pretrain" / "mirror.template.yaml"
N_PRETRAIN_SLIDES, TRAIN_STEPS = 64, 4
# feature extraction: Phikon ViT-B/16 at 224 px (patch 16: 197 tokens), d 768,
# 12 heads of 64, MLP 3072, depth 12, LN eps 1e-12, batch 256 (the CLI's
# default); 8 synthetic slides of 2,048 patches in all
VIT_B, VIT_N, VIT_D, VIT_HEADS, VIT_MLP, VIT_DEPTH, VIT_EPS = 256, 197, 768, 12, 3072, 12, 1e-12
FEATGEN_SLIDE_SIZES = (200, 312, 256, 180, 300, 264, 240, 296)  # 2048 patches, tails

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): bf16
# tensor cores dense, fp32 outside the tensor cores, HBM bandwidth. A
# kernel's bound is the larger of its bytes (each input read once, each
# output written once) over the bandwidth and its operations over the peak
# of their kind: the matrix products at the bf16 tensor-core rate, the
# conv taps and the other fp32 arithmetic at the fp32 rate.
PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12

# Bounds on the relative Frobenius error of a kernel against its plain
# version. Outputs rounded once to bf16 after an fp32 sum taken in another
# order: a bf16 rounding is at most 2^-9 = 2e-3 relative, and the attention
# also rounds its unnormalised probabilities before the product, so 1e-2
# leaves 5x room. The pinv chains 24 bf16 products whose one-ulp
# differences the 6 unconverged iterations amplify: 1e-1, and it is also
# held by function, |x z - I| no worse than 1.5x the plain version's.
BOUND_SINGLE_ROUNDING = 1e-2
BOUND_PINV = 1e-1
# The backward kernels: each output is rounded once to bf16 (2^-9), but
# dsim is rounded too before its products, and a probability that kernel
# and plain version compute one fp32 ulp apart can round dsim to the next
# bf16 value; dq and dk are sums of such terms with cancellation, so 2e-2.
BOUND_BWD = 2e-2
# The slide scores of the card (kernels, bf16) against the CPU's plain path
# (bf16): a relative error of the logits up to 5e-2, the drift of bf16
# rounding through two Nystrom layers and their pinvs; a wiring fault (a
# lost conv, pad or head order) moves them by O(1).
BOUND_LOGITS = 5e-2
# One train step at batch 2, card (kernels, bf16) against the CPU's plain
# path (bf16), same weights and draws: the loss within 2e-2 relative (bf16
# rounding through three Nystrom layers and their unconverged pinvs, summed
# in other orders), and the gradients that only the backward kernels feed
# (res_conv, to_qkv, the PPEG convs) at cosine >= 0.99 with norms within 5 %.
# A lost dkern, pad or head order moves them by O(1).
BOUND_STEP_LOSS, BOUND_GRAD_COS, BOUND_GRAD_NORM = 2e-2, 0.99, 5e-2
# Patch features of the card (kernels, bf16) against the CPU's plain path in
# fp32, same weights and patches: cosine >= 0.99 per patch (bf16 drift
# through 12 blocks; a wrong head, pad or rounding point moves it by O(1));
# the int8 path against bf16 on the card: cosine >= 0.995 per patch, the bar
# of tests/test_tools.py::test_vit_int8_features_match_bf16.
BOUND_FEAT_COS, BOUND_INT8_COS = 0.99, 0.995

FORWARD = ("landmark_softmax", "moore_penrose_pinv", "softmax_attn", "softmax_attn_conv",
           "ppeg")
BACKWARD = ("landmark_softmax_bwd", "softmax_attn_bwd", "softmax_attn_conv_bwd", "ppeg_bwd")
VIT = ("vit_attn_block", "vit_mlp_block", "vit_mha_natural")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's kernels need an NVIDIA card")
    if not (REPO / "mirror_tpu_torch" / "csrc").is_dir():
        fail(f"no mirror_tpu_torch/csrc beside {Path(__file__).name}: run it from a "
             "checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say(smi)
    say(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    # the plain versions are fp32 references: no TF32 in their products or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from mirror_tpu_torch.ops import _common

    t0 = time.perf_counter()
    lib = _common.build_library(force=True)
    _common.library()
    say(f"[build] {lib.relative_to(REPO)} from {_common.CSRC_DIR.relative_to(REPO)}/*.cu "
        f"in {time.perf_counter() - t0:.1f} s")


def median_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(torch, out, ref):
    """[(max abs error, relative Frobenius error)] of each output against
    its reference."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    refs = ref if isinstance(ref, (tuple, list)) else (ref,)
    result = []
    for o, r in zip(outs, refs, strict=True):
        if o.shape != r.shape or not torch.isfinite(o.float()).all():
            fail(f"kernel output shape {tuple(o.shape)} vs {tuple(r.shape)}, or not finite")
        d = o.float() - r.float()
        result.append((d.abs().max().item(), (d.norm() / r.float().norm()).item()))
    return result


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, mma_flops: float, fp32_flops: float = 0.0):
    """(least ms the card could take, what bounds it)."""
    ops = max(mma_flops / PEAK_BF16_FLOPS, fp32_flops / PEAK_FP32_FLOPS)
    if n_bytes / PEAK_BYTES >= ops:
        return n_bytes / PEAK_BYTES * 1e3, "bytes"
    return ops * 1e3, "operations"


class Case:
    """One kernel at one shape: how to call it, its plain version and the
    library call, the bytes and operations of its work, and an optional
    ``check(out, ref) -> bool`` that holds the output by function too."""

    def __init__(self, name, src, replaces, shape, kernel, plain, tol, outputs,
                 work, library=None, check=None):
        # src: the kernel's csrc file, or a tuple of them (the first is its
        # "source" in the JSON, all are its "sources")
        self.name, self.src, self.replaces, self.shape = name, src, replaces, shape
        self.kernel, self.plain, self.tol, self.outputs = kernel, plain, tol, outputs
        self.work, self.library, self.check = work, library, check


def run_case(torch, case: Case) -> dict:
    out = case.kernel()
    ref = case.plain()
    torch.cuda.synchronize()
    errs = errors(torch, out, ref)
    ok = all(rel <= case.tol for _, rel in errs)
    if case.check is not None:
        ok = case.check(out, ref) and ok
    ms, plain_ms = median_ms(torch, case.kernel), median_ms(torch, case.plain, reps=10)
    library_ms = median_ms(torch, case.library) if case.library else None
    bound_ms, bound_by = bound(case.work["bytes"], case.work["mma"], case.work.get("fp32", 0))
    per_output = ", ".join(f"{o} {a:.4g}/{r:.4g}" for o, (a, r) in zip(case.outputs, errs))
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    say(f"[kernel] {case.name} ({case.shape}): max abs / rel Frobenius err {per_output} "
        f"(bound {case.tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, "
        f"bound {bound_ms:.4f} ms by {bound_by} (medians of warm launches)")
    if not ok:
        fail(f"{case.name} ({case.shape}) disagrees with its plain version beyond its bound")
    sources = [f"mirror_tpu_torch/csrc/{f}"
               for f in (case.src if isinstance(case.src, tuple) else (case.src,))]
    return dict(name=case.name, route="cuda", source=sources[0], sources=sources,
                replaces=case.replaces, shape=case.shape,
                max_abs_err=max(a for a, _ in errs), rel_fro_err=max(r for _, r in errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def forward_cases(torch, randn):
    from mirror_tpu_torch.ops import landmark, nystrom_attn, pinv, ppeg

    import torch.nn.functional as F

    bf16 = torch.bfloat16
    bh = B * HEADS
    cases = []
    # the encoder's shape first (it gives the pinv its input and the q
    # variant its shape), then the retention decoder's
    for n, pad in ((N, PAD), (N_DEC, PAD_DEC)):
        shape = f"b {B}, h {HEADS}, n {n}, pad {pad}"
        q = randn(B, HEADS, n, DH, scale=DH ** -0.5)
        k, v = randn(B, HEADS, n, DH), randn(B, HEADS, n, DH)
        q_l, k_l, attn2 = landmark.landmark_softmax_ref(q, k, M, pad)
        w = randn(B, HEADS, M, DH)
        kern = randn(HEADS, CONV_TAPS, scale=CONV_TAPS ** -0.5)
        attn_mma = 4 * bh * n * M * DH  # S = q k^T and P w
        conv_fp32 = 2 * bh * n * DH * CONV_TAPS
        # kernel 3's function as one PyTorch call: its pad columns are
        # zero logits with zero w rows, so SDPA on explicitly zero-padded k
        # and w (built here, outside the timed call) computes it
        k_pad = torch.cat([k.new_zeros(B, HEADS, pad, DH), k], dim=2)
        v_pad = torch.cat([v.new_zeros(B, HEADS, pad, DH), v], dim=2)
        cases.append(Case(
            "landmark_softmax", "landmark.cu", "mirror_tpu/ops/landmark_pallas.py:183", shape,
            lambda q=q, k=k, pad=pad: landmark.landmark_softmax(q, k, M, pad),
            lambda q=q, k=k, pad=pad: landmark.landmark_softmax_ref(q, k, M, pad),
            BOUND_SINGLE_ROUNDING, ("q_l", "k_l", "attn2"),
            dict(bytes=nbytes(q, k, q_l, k_l, attn2), mma=2 * bh * M * M * DH)))
        cases.append(Case(
            "softmax_attn", "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:202",
            f"kv: r {M}, c {n}, pad {pad}",
            lambda q_l=q_l, k=k, v=v, pad=pad:
                nystrom_attn.softmax_matmul_landmark_kv(q_l, k, v, pad),
            lambda q_l=q_l, k=k, v=v, pad=pad:
                nystrom_attn.softmax_attn_ref(q_l, k, v, pad).to(bf16),
            BOUND_SINGLE_ROUNDING, ("out",),
            dict(bytes=nbytes(q_l, k, v, q_l), mma=attn_mma),
            library=lambda q_l=q_l, k_pad=k_pad, v_pad=v_pad:
                F.scaled_dot_product_attention(q_l, k_pad, v_pad, scale=1.0)))
        cases.append(Case(
            "softmax_attn_conv", "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:354",
            shape,
            lambda q=q, k_l=k_l, w=w, v=v, kern=kern:
                nystrom_attn.fused_softmax_attn_conv(q, k_l, w, v, kern),
            lambda q=q, k_l=k_l, w=w, v=v, kern=kern:
                (nystrom_attn.softmax_attn_ref(q, k_l, w)
                 + nystrom_attn.depthwise_conv_seq_ref(v, kern)).to(bf16),
            BOUND_SINGLE_ROUNDING, ("out",),
            dict(bytes=nbytes(q, k_l, w, v, kern, q), mma=attn_mma, fp32=conv_fp32)))
        if n != N:
            continue
        s = pinv.global_scale(attn2)

        def pinv_check(z, z_ref, x=attn2):
            # held by function too: |x z - I| no worse than 1.5x the plain
            # version's (or 0.05)
            eye = torch.eye(M, device=x.device)
            err = (x.float() @ z.float() - eye).abs().max().item()
            err_ref = (x.float() @ z_ref.float() - eye).abs().max().item()
            say(f"[kernel] moore_penrose_pinv: |x z - I| max {err:.4g} (plain {err_ref:.4g})")
            return err <= max(1.5 * err_ref, 0.05)

        cases.append(Case(
            "moore_penrose_pinv", "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:239",
            f"b {B}, h {HEADS}, m {M}", lambda x=attn2: pinv.moore_penrose_pinv(x),
            lambda x=attn2, s=s: pinv.pinv_iterations_ref(x, s), BOUND_PINV, ("z",),
            dict(bytes=2 * nbytes(attn2), mma=6 * 4 * 2 * bh * M ** 3), check=pinv_check))
        cases.append(Case(
            "softmax_attn_q", "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:208",
            f"q: r {n}, c {M}, pad 0",
            lambda q=q, k_l=k_l, w=w: nystrom_attn.softmax_matmul_landmark_q(q, k_l, w),
            lambda q=q, k_l=k_l, w=w: nystrom_attn.softmax_attn_ref(q, k_l, w).to(bf16),
            BOUND_SINGLE_ROUNDING, ("out",),
            dict(bytes=nbytes(q, k_l, w, q), mma=attn_mma),
            library=lambda q=q, k_l=k_l, w=w:
                F.scaled_dot_product_attention(q, k_l, w, scale=1.0)))

    img = randn(B, SIDE, SIDE, EMBED)
    ppeg_k, ppeg_b = randn(7, 7, EMBED, scale=0.1), randn(EMBED, scale=0.1)
    # PPEG as one depthwise conv: the identity folded into the centre tap
    conv_w = ppeg_k.permute(2, 0, 1).unsqueeze(1).clone()  # [C, 1, 7, 7]
    conv_w[:, 0, 3, 3] += 1
    img_nchw = img.permute(0, 3, 1, 2)  # a channels-last view
    cases.append(Case(
        "ppeg", "ppeg.cu", "mirror_tpu/ops/ppeg_pallas.py:179",
        f"[{B}, {SIDE}, {SIDE}, {EMBED}]", lambda: ppeg.ppeg_fused(img, ppeg_k, ppeg_b),
        lambda: ppeg.ppeg_ref(img, ppeg_k, ppeg_b), BOUND_SINGLE_ROUNDING, ("out",),
        dict(bytes=nbytes(img, ppeg_k, ppeg_b, img), mma=0, fp32=(2 * 49 + 2) * img.numel()),
        library=lambda: F.conv2d(img_nchw, conv_w, ppeg_b, padding=3, groups=EMBED)))
    return cases + vit_cases(torch, randn)


def vit_cases(torch, randn):
    """The ViT half-block kernels at Phikon's shapes: x [256, 197, 768] bf16,
    weights bf16 [in, out], LN and biases fp32, eps 1e-12."""
    import torch.nn.functional as F

    from mirror_tpu_torch.ops import vit_attn

    b, n, d, h, m = VIT_B, VIT_N, VIT_D, VIT_HEADS, VIT_MLP
    dh, rows = d // h, VIT_B * VIT_N

    def f32(*shape, scale=1.0):
        return randn(*shape, scale=scale).float()

    x = randn(b, n, d)
    ln_s, ln_b = 1.0 + f32(d, scale=0.1), f32(d, scale=0.1)
    wq, wk, wv, wo = (randn(d, d, scale=d ** -0.5) for _ in range(4))
    attn_args = (x, ln_s, ln_b, wq, wk, wv, f32(3 * d, scale=0.1), wo, f32(d, scale=0.1))
    mlp_args = (x, ln_s, ln_b, randn(d, m, scale=d ** -0.5), f32(m, scale=0.1),
                randn(m, d, scale=m ** -0.5), f32(d, scale=0.1))
    q, k, v = randn(b, n, d), randn(b, n, d), randn(b, n, d)

    def by_head(t):  # the [b, h, n, dh] view SDPA takes
        return t.view(b, n, h, dh).transpose(1, 2)

    def added_term(name):
        """Holds what a half-block adds to x, out - x, against the plain
        version's: x passes through unchanged and is ~8x the added term at
        these scales, so the whole output alone would dilute a fault there."""
        def check(out, ref):
            xf = x.float()
            got, want = out.float() - xf, ref.float() - xf
            rel = ((got - want).norm() / want.norm()).item()
            say(f"[kernel] {name}: out - x rel Frobenius err {rel:.4g} "
                f"(bound {BOUND_SINGLE_ROUNDING:g})")
            return rel <= BOUND_SINGLE_ROUNDING
        return check

    attn_mma = 4 * b * h * n * n * dh  # q k^T and P v
    softmax_fp32 = 5 * b * h * n * n  # scale, max, exp, sum, divide
    ln_fp32 = 10 * rows * d  # statistics and the affine, the residual add
    shape = f"b {b}, n {n}, d {d}, heads {h}"
    return [
        Case("vit_attn_block", ("vit_gemm.cu", "vit_attn.cu"),
             "mirror_tpu/ops/vit_attn_pallas.py:255", shape,
             lambda: vit_attn.attn_block(*attn_args, h, VIT_EPS),
             lambda: vit_attn.attn_block_ref(*attn_args, h, VIT_EPS),
             BOUND_SINGLE_ROUNDING, ("out",),
             dict(bytes=nbytes(*attn_args, x), mma=2 * rows * d * 4 * d + attn_mma,
                  fp32=softmax_fp32 + ln_fp32), check=added_term("vit_attn_block")),
        Case("vit_mlp_block", "vit_gemm.cu", "mirror_tpu/ops/vit_attn_pallas.py:276",
             f"{shape}, mlp {m}", lambda: vit_attn.mlp_block(*mlp_args, VIT_EPS),
             lambda: vit_attn.mlp_block_ref(*mlp_args, VIT_EPS), BOUND_SINGLE_ROUNDING, ("out",),
             dict(bytes=nbytes(*mlp_args, x), mma=4 * rows * d * m,
                  fp32=10 * rows * m + ln_fp32),  # bias and the erf GELU
             check=added_term("vit_mlp_block")),
        Case("vit_mha_natural", "vit_attn.cu", "mirror_tpu/ops/vit_attn_pallas.py:242", shape,
             lambda: vit_attn.mha_natural(q, k, v, h),
             lambda: vit_attn.mha_natural_ref(q, k, v, h), BOUND_SINGLE_ROUNDING, ("out",),
             dict(bytes=4 * nbytes(q), mma=attn_mma, fp32=softmax_fp32),
             library=lambda: F.scaled_dot_product_attention(by_head(q), by_head(k), by_head(v))),
    ]


def autograd_kernel(torch, fn, inputs, grads):
    """A callable that runs only the backward of ``fn`` (the kernel behind
    its autograd Function) for the incoming ``grads``: the forward runs
    once here, and its graph is kept for repeated calls."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return lambda: torch.autograd.grad(outs, leaves, grads, retain_graph=True)


def backward_cases(torch, randn):
    import torch.nn.functional as F

    from mirror_tpu_torch.ops import landmark, nystrom_attn, ppeg

    bh = B * HEADS
    cases = []
    for n, pad in ((N, PAD), (N_DEC, PAD_DEC)):
        shape = f"b {B}, h {HEADS}, n {n}, pad {pad}"
        q = randn(B, HEADS, n, DH, scale=DH ** -0.5)
        k, v = randn(B, HEADS, n, DH), randn(B, HEADS, n, DH)
        q_l, k_l, _ = landmark.landmark_softmax_ref(q, k, M, pad)
        gql, gkl, ga2 = randn(B, HEADS, M, DH), randn(B, HEADS, M, DH), randn(B, HEADS, M, M)
        dq = landmark.landmark_softmax_bwd_ref(q, k, M, pad, gql, gkl, ga2)[0]
        cases.append(Case(
            "landmark_softmax_bwd", "landmark.cu", "mirror_tpu/ops/landmark_pallas.py:148",
            shape,
            autograd_kernel(torch, lambda q, k, pad=pad: landmark.landmark_softmax(q, k, M, pad),
                            (q, k), (gql, gkl, ga2)),
            lambda q=q, k=k, pad=pad, g=(gql, gkl, ga2): landmark.landmark_softmax_bwd_ref(
                q, k, M, pad, *g),
            BOUND_BWD, ("dq", "dk"),
            dict(bytes=nbytes(q, k, gql, gkl, ga2, dq, dq), mma=3 * 2 * bh * M * M * DH)))

        g3 = randn(B, HEADS, M, DH)
        # the same SDPA on zero-padded k and w (built outside the timed
        # call), its backward through autograd: kernel 3c's function
        k_pad = torch.cat([k.new_zeros(B, HEADS, pad, DH), k], dim=2)
        v_pad = torch.cat([v.new_zeros(B, HEADS, pad, DH), v], dim=2)
        cases.append(Case(
            "softmax_attn_bwd", "softmax_attn_bwd.cu", "mirror_tpu/ops/nystrom_pallas.py:152",
            f"kv: r {M}, c {n}, pad {pad}",
            autograd_kernel(torch, lambda a, b, c, pad=pad:
                            nystrom_attn.softmax_matmul_landmark_kv(a, b, c, pad),
                            (q_l, k, v), (g3,)),
            lambda q_l=q_l, k=k, v=v, g3=g3, pad=pad: nystrom_attn.softmax_attn_bwd_ref(
                q_l, k, v, g3, pad),
            BOUND_BWD, ("dq_l", "dk", "dv"),
            dict(bytes=2 * nbytes(q_l, k, v) + nbytes(g3), mma=5 * 2 * bh * M * n * DH),
            library=autograd_kernel(
                torch, lambda a, b, c: F.scaled_dot_product_attention(a, b, c, scale=1.0),
                (q_l, k_pad, v_pad), (g3,))))

        w = randn(B, HEADS, M, DH)
        kern = randn(HEADS, CONV_TAPS, scale=CONV_TAPS ** -0.5)
        g4 = randn(B, HEADS, n, DH)
        cases.append(Case(
            "softmax_attn_conv_bwd", "softmax_attn_bwd.cu",
            "mirror_tpu/ops/nystrom_pallas.py:318", shape,
            autograd_kernel(torch, nystrom_attn.fused_softmax_attn_conv,
                            (q, k_l, w, v, kern), (g4,)),
            lambda q=q, k_l=k_l, w=w, v=v, kern=kern, g4=g4: (
                *nystrom_attn.softmax_attn_bwd_ref(q, k_l, w, g4),
                *nystrom_attn.depthwise_conv_seq_bwd_ref(v, kern, g4)),
            BOUND_BWD, ("dq", "dk_l", "dw", "dv", "dkern"),
            dict(bytes=2 * nbytes(q, k_l, w, v, kern) + nbytes(g4),
                 mma=5 * 2 * bh * n * M * DH, fp32=2 * 2 * bh * n * DH * CONV_TAPS)))

    img = randn(B, SIDE, SIDE, EMBED)
    kern, bias = randn(7, 7, EMBED, scale=0.1), randn(EMBED, scale=0.1)
    g5 = randn(B, SIDE, SIDE, EMBED)
    conv_w = kern.permute(2, 0, 1).unsqueeze(1).clone()
    conv_w[:, 0, 3, 3] += 1
    img_nchw, g5_nchw = img.permute(0, 3, 1, 2), g5.permute(0, 3, 1, 2)
    cases.append(Case(
        "ppeg_bwd", "ppeg.cu", "mirror_tpu/ops/ppeg_pallas.py:137",
        f"[{B}, {SIDE}, {SIDE}, {EMBED}]",
        autograd_kernel(torch, ppeg.ppeg_fused, (img, kern, bias), (g5,)),
        lambda: ppeg.ppeg_bwd_ref(img, kern, g5), BOUND_BWD, ("dimg", "dk", "db"),
        dict(bytes=3 * nbytes(img) + 2 * nbytes(kern) + nbytes(bias), mma=0,
             fp32=(2 * 49 * 2 + 2) * img.numel()),
        # dinput, dweight and dbias of the depthwise conv with the identity
        # folded into its centre tap: one PyTorch call
        library=lambda: torch.ops.aten.convolution_backward(
            g5_nchw, img_nchw, conv_w, [EMBED], [1, 1], [3, 3], [1, 1], False, [0, 0],
            EMBED, [True, True, True])))
    return cases


def phase_kernels(torch, backward: bool):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + int(backward))

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    cases = backward_cases(torch, randn) if backward else forward_cases(torch, randn)
    results = []
    for case in cases:
        results.append(run_case(torch, case))
    del cases
    torch.cuda.empty_cache()
    # one line per kernel in the JSON: the encoder's shape (the first) gives
    # the times; the errors are the worst over the shapes checked
    merged = {}
    for r in results:
        if r["name"] not in merged:
            merged[r["name"]] = dict(r, checked=[r["shape"]])
            continue
        first = merged[r["name"]]
        first["checked"].append(r["shape"])
        first["max_abs_err"] = max(first["max_abs_err"], r["max_abs_err"])
        first["rel_fro_err"] = max(first["rel_fro_err"], r["rel_fro_err"])
    return list(merged.values())


def write_cohort(root: Path, n_slides: int, prefix: str):
    """n_slides slides of 1000-4000 fp16 Phikon-width patches, an RNA CSV
    with 10234 genes, all from numpy generators seeded with SEED."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(SEED)
    feat_dir = root / "features"
    feat_dir.mkdir()
    ids = [f"TCGA-{prefix}-{i:04d}-01Z-00-DX1" for i in range(n_slides)]
    for sid in ids:
        n = int(rng.integers(1000, 4001))
        np.save(feat_dir / f"{sid}.npy",
                rng.standard_normal((n, 768), dtype=np.float32).astype(np.float16))
    rna = rng.standard_normal((n_slides, RNA_DIM), dtype=np.float32)
    pd.DataFrame(rna, index=[s[:15] for s in ids],
                 columns=[f"gene_{j}" for j in range(RNA_DIM)]).to_csv(root / "rna.csv")
    return feat_dir, root / "rna.csv", ids


def phase_slice(torch, root: Path):
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch.data.formats import load_feature_file
    from mirror_tpu_torch.ops import _common
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.tools.predict import predict
    from mirror_tpu_torch.train.checkpoint import save_checkpoint_file

    args = dict(model="mirror_classifier", model_kwargs=MODEL_KWARGS, num_classes=2,
                classes=["LUAD", "LUSC"], num_wsi_feature_tokens=N_TOKENS, batch_size=B,
                amp=True, amp_dtype="bfloat16", wsi_feature_only=False)
    t0 = time.perf_counter()
    model = create_model("mirror_classifier", device="cpu",
                         generator=torch.Generator().manual_seed(SEED), num_classes=2,
                         **MODEL_KWARGS)
    ckpt = root / "model_best.pth.tar"
    save_checkpoint_file(str(ckpt), model.state_dict(), args=args)
    n_params = sum(p.numel() for p in model.parameters())
    feat_dir, rna_csv, ids = write_cohort(root, N_SLIDES, "SM")
    say(f"[slice] {n_params} random parameters saved to a .pth.tar; {N_SLIDES} slides "
        f"written, set-up {time.perf_counter() - t0:.1f} s")

    out_csv = root / "predictions.csv"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _common.reset_launch_counts()
    t0 = time.perf_counter()
    predict(str(ckpt), "subtyping", str(feat_dir), str(out_csv),
            rna_feature_csv=str(rna_csv), batch_size=B, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _common.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    say(f"[slice] predict scored {N_SLIDES} slides in {seconds:.2f} s: "
        f"{N_SLIDES / seconds:.2f} slides/s (file reads and CSV included), peak device "
        f"memory {peak_gib:.2f} GiB; kernel launches {json.dumps(launches)}")

    df = pd.read_csv(out_csv)
    probs = df[["prob_0", "prob_1"]].to_numpy()
    if list(df["slide_id"]) != ids:
        fail(f"CSV slide ids differ from the {N_SLIDES} slides written")
    if not np.isfinite(probs).all() or np.abs(probs.sum(1) - 1.0).max() > 1e-5:
        fail("probabilities not finite or rows not summing to 1")
    say(f"[slice] CSV: {len(df)} rows, probabilities finite, rows sum to 1 "
        f"(max |sum - 1| {np.abs(probs.sum(1) - 1.0).max():.2g})")

    # reference on a small input: two slides through the card's kernel path
    # and through the CPU's plain path, same weights, same tokens, bf16
    rng = np.random.default_rng(SEED)
    wsi = []
    for sid in ids[:2]:
        feats = np.asarray(load_feature_file(str(feat_dir / f"{sid}.npy")), np.float32)
        idx = rng.choice(feats.shape[0], N_TOKENS, replace=feats.shape[0] < N_TOKENS)
        wsi.append(feats[idx])
    rna = pd.read_csv(rna_csv, index_col=0).to_numpy(np.float32)[:2]
    wsi_t, rna_t = torch.from_numpy(np.stack(wsi)), torch.from_numpy(rna)
    sd = model.state_dict()
    with torch.no_grad():
        gpu_model = create_model("mirror_classifier", device="cuda", num_classes=2,
                                 dtype="bfloat16", **MODEL_KWARGS)
        gpu_model.load_state_dict(sd)
        got = gpu_model(wsi_t.cuda(), rna_t.cuda()).float().cpu()
        cpu_model = create_model("mirror_classifier", device="cpu", num_classes=2,
                                 dtype="bfloat16", **MODEL_KWARGS)
        cpu_model.load_state_dict(sd)
        want = cpu_model(wsi_t, rna_t).float()
    rel = ((got - want).norm() / want.norm()).item()
    say(f"[slice] 2 slides, card kernels vs CPU plain path (bf16): logits {got.tolist()} "
        f"vs {want.tolist()}, relative error {rel:.4g} (bound {BOUND_LOGITS:g})")
    if not torch.isfinite(got).all() or rel > BOUND_LOGITS:
        fail("the card's logits disagree with the CPU reference")
    missing = [k for k in FORWARD if launches.get(k, 0) == 0]
    if missing:
        fail(f"predict never launched: {missing}")
    return launches


def write_pretrain_cohort(root: Path):
    """The pretrain cohort and a fold-0 split that trains on all of it."""
    import pandas as pd

    feat_dir, rna_csv, ids = write_cohort(root, N_PRETRAIN_SLIDES, "PT")
    split_dir = root / "splits"
    split_dir.mkdir()
    pd.DataFrame({"train": [s[:12] for s in ids], "val": [None] * len(ids)}).to_csv(
        split_dir / "splits_0.csv")
    return feat_dir, rna_csv, split_dir


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def profile_step(torch, train_step, batch, step_ms, tag="train", what="step"):
    """One step under torch.profiler: device time by kernel, top 12."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(batch)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the device's own events (kernels, copies, fills), not the host ops
    # that launched them
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events) / 1e3
    if total == 0:
        say(f"[{tag}] profiler: no device time recorded (time with CUDA events instead)")
        return
    say(f"[{tag}] profiler, one {what}: {total:.3f} ms of device time against a {what} of "
        f"{step_ms:.3f} ms (busy {100 * total / step_ms:.1f} %); by kernel:")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        say(f"[{tag}]   {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / 1e3 / total:5.1f} % "
            f"x{e.count:<4d} {e.key[:90]}")


def train_step_card_vs_cpu(torch, model_kwargs, args, wsi, rna):
    """One train step at batch 2: the card's kernels against the CPU's plain
    path, same weights, same masking noise and VAE eps, dropout 0."""
    import numpy as np

    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_mirror_train_step
    from mirror_tpu_torch.train_mirror import loss_weights_from_args

    t0 = time.perf_counter()
    kw = dict(model_kwargs, wsi_dropout=0.0, rna_proj_drop_rate=0.0)
    rng = np.random.default_rng(SEED)
    noise = dict(wsi_noise=rng.random((2, N_TOKENS), dtype=np.float32),
                 rna_noise=rng.random((2, EMBED), dtype=np.float32),
                 wsi_eps=rng.standard_normal((2, 128), dtype=np.float32),
                 rna_eps=rng.standard_normal((2, 128), dtype=np.float32))
    batch = dict(wsi=torch.from_numpy(wsi[:2]), rna=torch.from_numpy(rna[:2]))
    state = None
    results = {}
    for device in ("cuda", "cpu"):
        model = create_model("mirror", device=device,
                             generator=None if state else torch.Generator().manual_seed(SEED),
                             **kw)
        if state is None:
            state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        step = make_mirror_train_step(model, make_optimizer(args, model, 2e-5),
                                      loss_weights_from_args(args), args.wsi_mask_ratio,
                                      args.rna_mask_ratio)
        metrics = step({k: v.to(device) for k, v in batch.items()},
                       noise={k: torch.from_numpy(v).to(device) for k, v in noise.items()})
        grads = {name: p.grad.detach().float().cpu() for name, p in model.named_parameters()
                 if p.grad is not None and ("res_conv.weight" in name or "to_qkv.weight" in name
                                            or "pos_layer.proj" in name)}
        results[device] = (float(metrics["loss"]), grads)
        del model, step
    loss_gpu, g_gpu = results["cuda"]
    loss_cpu, g_cpu = results["cpu"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    say(f"[train] one step at batch 2, card kernels vs CPU plain path (bf16): loss "
        f"{loss_gpu:.6g} vs {loss_cpu:.6g}, relative error {rel:.4g} (bound "
        f"{BOUND_STEP_LOSS:g}); {time.perf_counter() - t0:.1f} s")
    if not np.isfinite(loss_gpu) or rel > BOUND_STEP_LOSS:
        fail("the card's train-step loss disagrees with the CPU reference")
    if set(g_gpu) != set(g_cpu) or len(g_gpu) != 3 * 2 + 6:
        fail(f"kernel-fed gradient leaves differ: {sorted(g_gpu)} vs {sorted(g_cpu)}")
    worst = []
    for name in sorted(g_cpu):
        a, b = g_gpu[name].ravel(), g_cpu[name].ravel()
        cos = (a @ b / (a.norm() * b.norm())).item()
        ratio = (a.norm() / b.norm()).item()
        say(f"[train]   grad {name}: cosine {cos:.6f}, norm ratio {ratio:.5f}")
        worst.append(cos)
        if not (cos >= BOUND_GRAD_COS and abs(ratio - 1.0) <= BOUND_GRAD_NORM):
            fail(f"gradient of {name} on the card disagrees with the CPU reference")
    return min(worst), rel


def phase_train(torch, root: Path):
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch import train_mirror
    from mirror_tpu_torch.config import parse_args, resolve_lr
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader
    from mirror_tpu_torch.ops import _common
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_mirror_train_step

    t0 = time.perf_counter()
    feat_dir, rna_csv, split_dir = write_pretrain_cohort(root)
    argv = ["--config", str(PRETRAIN_YAML), "--wsi-feature-dir", str(feat_dir),
            "--rna-feature-csv", str(rna_csv), "--split-dir", str(split_dir), "--fold-nb", "0",
            "--output", str(root / "runs"), "--experiment", "smoke", "--epochs", "1",
            "--no-val", "--batch-size", str(B), "--log-interval", "1", "--seed", str(SEED),
            "--workers", "8"]
    say(f"[train] {N_PRETRAIN_SLIDES} slides written, set-up {time.perf_counter() - t0:.1f} s")

    lines = _Lines()
    logging.getLogger("train").addHandler(lines)
    torch.cuda.synchronize()
    _common.reset_launch_counts()
    t0 = time.perf_counter()
    results = train_mirror.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _common.launch_counts()
    logging.getLogger("train").removeHandler(lines)
    say(f"[train] train_mirror: {TRAIN_STEPS} steps at batch {B} in {seconds:.2f} s (model "
        f"build, data reads and checkpoint save included); kernel launches "
        f"{json.dumps(launches)}")

    steps = [ln for ln in lines.lines if ln.startswith("Train:")]
    if len(steps) != TRAIN_STEPS:
        fail(f"{len(steps)} train log lines, expected {TRAIN_STEPS}")
    if any(bad in ln.lower() for ln in steps for bad in ("nan", "inf")):
        fail(f"a logged loss is not finite: {steps}")
    run_dir = root / "runs" / "pretrain" / "smoke"
    summary = pd.read_csv(run_dir / "summary.csv")
    names = ["loss", "alignment_loss", "wsi_retention_loss", "rna_retention_loss",
             "style_loss", "cluster_loss"]
    if not np.isfinite(summary[[f"train_{n}" for n in names]].to_numpy()).all():
        fail("a loss in summary.csv is not finite")
    if results.get("metric_name") != "loss" or not np.isfinite(results["best_metric"]):
        fail(f"--result is not what a finished run prints: {results}")
    say(f"[train] every logged loss finite; last line: {steps[-1]}")
    missing = [k for k in FORWARD + BACKWARD if launches.get(k, 0) == 0]
    if missing:
        fail(f"the train step never launched: {missing}")

    args, _ = parse_args(argv)
    payload = load_checkpoint_file(str(run_dir / "last.pth.tar"))
    model_kwargs = run_args(payload)["model_kwargs"]
    model = create_model("mirror", device="cuda", **model_kwargs)
    model.load_state_dict(payload["state_dict"])
    say(f"[train] last.pth.tar reloads into create_model('mirror'): "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    # ms per step on one resident batch: CUDA events around each of 10
    # steps after 2 warm ones
    dataset = PretrainDataset(str(feat_dir), str(rna_csv), N_TOKENS, splits=str(split_dir))
    host = next(iter(Loader(dataset, B, shuffle=True, seed=SEED, workers=8)))
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    model = create_model("mirror", device="cuda",
                         generator=torch.Generator().manual_seed(SEED), **model_kwargs)
    train_step = make_mirror_train_step(
        model, make_optimizer(args, model, resolve_lr(args, B)),
        train_mirror.loss_weights_from_args(args), args.wsi_mask_ratio, args.rna_mask_ratio,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        train_step(batch)
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = train_step(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    say(f"[train] train step at batch {B}, full width, bf16: median {step_ms:.3f} ms over 10 "
        f"(min {min(times):.3f}, max {max(times):.3f}), {1000 * B / step_ms:.1f} samples/s; "
        f"peak device memory {peak_gib:.2f} GiB; loss {float(metrics['loss']):.6g}")
    profile_step(torch, train_step, batch, step_ms)
    del model, train_step, batch
    torch.cuda.empty_cache()

    cos, rel = train_step_card_vs_cpu(torch, model_kwargs, args, host["wsi"], host["rna"])
    return launches, dict(step_ms=step_ms, peak_gib=peak_gib, worst_grad_cos=cos,
                          step_loss_rel=rel)


def write_patches(root: Path):
    """8 slides of 224x224 RGB JPEG patches ({root}/{class}/{slide}/), 2,048
    in all: 14x14 random colour blocks of 16 px plus noise, from SEED."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(SEED)
    slides = []
    for i, count in enumerate(FEATGEN_SLIDE_SIZES):
        slide = Path(("LUAD", "LUSC")[i % 2]) / f"TCGA-FG-{i:04d}-01Z-00-DX1"
        (root / slide).mkdir(parents=True)
        for j in range(count):
            blocks = rng.integers(0, 256, (14, 14, 3), dtype=np.uint8).repeat(16, 0).repeat(16, 1)
            noise = rng.integers(-12, 13, blocks.shape)
            img = np.clip(blocks.astype(np.int16) + noise, 0, 255).astype(np.uint8)
            cv2.imwrite(str(root / slide / f"{j:05d}.jpeg"), img)
        slides.append((str(slide), count))
    return slides


def time_backbone(torch, fn, images, label):
    """Median ms of the backbone on one resident uint8 batch: CUDA events
    around each of 10 calls after 2 warm ones."""
    for _ in range(2):
        fn(images)
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(images)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    say(f"[featgen] {label} backbone, batch {images.shape[0]} resident uint8: median {ms:.3f} ms "
        f"over 10 (min {min(times):.3f}, max {max(times):.3f}), "
        f"{1000 * images.shape[0] / ms:.1f} patches/s")
    return ms


def cosines(torch, a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def phase_featgen(torch, root: Path):
    """Feature extraction through its CLI entry point: Phikon (bf16 kernels),
    Phikon --quant int8 and the truncated ResNet50, then the Phikon backbone
    timed and profiled on one resident batch, then 8 patches checked
    against the CPU's plain path."""
    import cv2
    import numpy as np

    from mirror_tpu_torch.data.formats import load_feature_file
    from mirror_tpu_torch.models.feature_extractors import ViTB16, device_normalize
    from mirror_tpu_torch.ops import _common
    from mirror_tpu_torch.tools import gen_patch_feature

    t0 = time.perf_counter()
    patches = root / "patches"
    slides = write_patches(patches)
    n_batches = sum(-(-count // VIT_B) for _, count in slides)
    say(f"[featgen] {len(slides)} slides, {sum(c for _, c in slides)} JPEG patches written in "
        f"{time.perf_counter() - t0:.1f} s ({n_batches} batches of {VIT_B} with the tails); "
        f"decoder: cv2 {cv2.__version__}")

    runs = {"phikon": ([], 768, {"vit_attn_block": VIT_DEPTH, "vit_mlp_block": VIT_DEPTH}),
            "phikon_int8": (["--quant", "int8"], 768, {"vit_mha_natural": VIT_DEPTH}),
            "custom_resnet50": ([], 1024, {})}
    launches = {}
    for run, (extra, dim, per_batch) in runs.items():
        out = root / run
        model = "custom_resnet50" if run == "custom_resnet50" else "phikon"
        argv = [str(patches), str(out), "--model", model, "--batch-size", str(VIT_B),
                "--device", "cuda", *extra]
        torch.cuda.synchronize()
        _common.reset_launch_counts()
        stats = gen_patch_feature.main(argv)
        torch.cuda.synchronize()
        counts = _common.launch_counts()
        say(f"[featgen] gen_patch_feature {' '.join(argv[2:])}: {stats['patches']} patches in "
            f"{stats['seconds']:.2f} s, {stats['patches_per_sec']:.1f} patches/s (host clock, "
            f"decode and writes included, model build not); launches {json.dumps(counts)}")
        want = {k: per * n_batches for k, per in per_batch.items()}
        if counts != want:
            fail(f"{run}: kernel launches {counts}, expected {want}")
        for kname in want:
            launches[kname] = launches.get(kname, 0) + counts.get(kname, 0)
        for slide, count in slides:
            feats = np.asarray(load_feature_file(str(out / f"{slide}.npy")))
            if feats.shape != (count, dim) or not np.isfinite(feats).all():
                fail(f"{run}: {slide} features {feats.shape}, expected ({count}, {dim}) finite")
        say(f"[featgen]   {len(slides)} files, each [n, {dim}] and finite")

    # the backbones on one resident batch of 256 (decode and copies out of the
    # way): ms per batch and peak memory; a profile of the Phikon batch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images = torch.randint(0, 256, (VIT_B, 224, 224, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    fn, _ = gen_patch_feature.build_extractor("phikon", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_ms = time_backbone(torch, fn, images, "phikon (bf16 kernels)")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    say(f"[featgen] phikon peak device memory {peak_gib:.2f} GiB")
    profile_step(torch, fn, images, batch_ms, tag="featgen", what="batch")
    fn_int8, _ = gen_patch_feature.build_extractor("phikon", quant="int8", device="cuda")
    time_backbone(torch, fn_int8, images, "phikon --quant int8")
    fn_resnet, _ = gen_patch_feature.build_extractor("custom_resnet50", device="cuda")
    time_backbone(torch, fn_resnet, images, "custom_resnet50")
    del fn_resnet
    torch.cuda.empty_cache()

    # 8 patches: card (bf16 kernels) against the CPU's plain path in fp32,
    # and int8 against bf16 on the card, all on the same weights
    first = patches / slides[0][0]
    files = sorted(first.iterdir())[:8]
    batch = np.stack([gen_patch_feature.decode_patch(str(f)) for f in files])
    cpu_model = ViTB16().eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in fn.model.state_dict().items()})
    with torch.no_grad():
        want = cpu_model(device_normalize(torch.from_numpy(batch)))
    got, got_int8 = fn(batch), fn_int8(batch)
    cos, cos_int8 = cosines(torch, got, want), cosines(torch, got_int8, got)
    say(f"[featgen] 8 patches, card kernels (bf16) vs CPU plain path (fp32): cosine min "
        f"{cos.min().item():.6f} (bound {BOUND_FEAT_COS}); int8 vs bf16 on the card: cosine "
        f"min {cos_int8.min().item():.6f} (bound {BOUND_INT8_COS})")
    if not (cos >= BOUND_FEAT_COS).all():
        fail("the card's patch features disagree with the CPU reference")
    if not (cos_int8 >= BOUND_INT8_COS).all():
        fail("the int8 patch features disagree with the bf16 ones")
    return launches


def main() -> int:
    import torch

    phase_device(torch)
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(8)
    t_start = time.perf_counter()
    phase_build()
    kernels = phase_kernels(torch, backward=False)
    kernels += phase_kernels(torch, backward=True)
    build_root = REPO / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        serve = phase_slice(torch, Path(tmp))
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        train, _ = phase_train(torch, Path(tmp))
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        featgen = phase_featgen(torch, Path(tmp))
    # the main paths' launches: predict's, the train step's and feature
    # extraction's (its three runs), each counted from 0 just before its run;
    # softmax_attn_q is the pad-0 entry of the softmax_attn kernel, which no
    # path calls (its callers all have the residual conv)
    paths = {"predict": serve, "train": train, "featgen": featgen}
    for k in kernels:
        k["launches_by_path"] = {path: counts.get(k["name"], 0) for path, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    say(f"[done] {time.perf_counter() - t_start:.1f} s after the device check")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
