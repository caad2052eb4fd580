#!/usr/bin/env python3
"""Drive the PyTorch port of MIRROR once on one NVIDIA card, and check it.

    python3 chip_smoke.py            # from the repo root; one CUDA card, nvcc

Phases, each printed as it finishes:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of ``mirror_tpu_torch/csrc`` compiled from the
   checkout's sources, with its build time, and what ``-Xptxas -v`` says
   of the redesigned kernels (the landmark softmax, the Nystrom and ViT
   attention, PPEG, the pinv's GEMM, the ViT projection GEMM and its LN
   pass, the copy floor, the fused ViT sub-layers: registers, shared
   memory, spills, ptxas's performance warnings);
3. kernels: each forward kernel against its plain PyTorch version on the
   card, at the shapes the slices give it (batch 16, 8 heads, dh 96, 384
   landmarks; the encoder's 2117 rows with front pad 187 and the retention
   decoder's 2049 rows with pad 255; the pad-0 q variant at its own shapes;
   PPEG on [16, 46, 46, 768]; the ViT half-blocks and the natural-layout
   attention at Phikon's batch of 256: x [256, 197, 768], 12 heads, MLP
   3072, eps 1e-12, and their parts alone: the LN pass on [50432, 768] and
   the projection GEMM in its four launches, q|k|v [50432, 768] x [768,
   2304] + bias, fc1 x [768, 3072] + bias, GELU, fc2 [50432, 3072] x [3072,
   768] and the output projection x [768, 768], + bias + x, each against
   ``torch.addmm(bias, y, W)`` on the same operands, a yardstick that does
   less; the standalone conv at [16, 8, 2117, 96] with bf16
   taps and at the self-test's [8, 8, 2117, 96] with fp32 taps; the fused
   LN + q/k/v projection at x [16, 2117, 768], 8 heads of 96), and the
   Nystrom kernels and PPEG again at the self-test's shapes (batch 8, dh 64,
   256 landmarks, n 2117, pad 187; PPEG on [8, 46, 46, 512]), bf16: max
   abs error, relative Frobenius error, the bound, the median time of
   kernel, plain version and (where one PyTorch call computes the same
   function, or two for the LN + q/k/v projection, or the few the probe's
   ``library_*`` variants make for the fused ViT sub-layers) that call,
   each also as single calls between two events; the achieved TFLOP/s (the
   products the function needs over the kernel's time), the kernel /
   library ratio, the bound over the kernel's time, and for the attention
   the design's count of products run and needed (from the source notes,
   not measured);
3b. backward kernels: each against its plain version fed the same inputs
   and incoming gradient, at the train slice's shapes (the encoder's 2117
   rows with pad 187 and the retention decoder's 2049 rows with pad 255;
   PPEG on [16, 46, 46, 768]; the exact pinv backward, kernel 2b, at
   [16, 8, 384, 384] and 6 iterations on a softmax-like input; the conv
   and the LN + q/k/v projection at phase 3's shapes; the Nystrom
   backwards, 2b ([8, 8, 256, 256]) and PPEG's at the self-test's shapes
   as in phase 3), error per output
   (the batch sums dkern, gw, gs and gb also against their largest
   magnitude), and the same times; the landmark softmax's backward (1b),
   the attention backwards (3c, 4b), PPEG's (5b) and the exact pinv
   backward (2b) run twice on the same inputs and must give the same bits;
   one launch of the pinv's GEMM at [128, 384, 384] in its four main forms
   (NN with 7I - xz, NN adding to ``prev``, TN adding to fp32 gx, NT
   scaled) against its plain version and one cuBLAS call, and kernels 2
   and 2b also against their launch sequences' bytes floor, and kernels 1
   and 1b also against the bound of their bytes with the TPU kernel's
   residuals (no lse; q and k read again by the backward); kernels 1, 1b
   and 2b are timed on their launch wrappers (1b from the card's forward
   residuals), the other backwards through autograd;
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
   feed); then 2 steps at batch 16 with ``--pinv-grad exact`` through
   ``train_mirror.main`` (kernel 2b's launches read around it), and that
   step timed (ms, peak memory) and profiled;
6. feature extraction: 8 synthetic slides of 2,048 224x224 JPEG patches in
   all (``{root}/{class}/{slide}/``), run through
   ``mirror_tpu_torch.tools.gen_patch_feature.main`` three times at batch
   256 on the card (``--model phikon``, ``--model phikon --quant int8``,
   ``--model custom_resnet50``; random weights from a seed), launch counts
   read around each run (12 of each half-block kernel per Phikon batch, and
   within them 24 LN passes and 48 GEMM launches; 12 attention launches per
   int8 batch), every file [n, 768] or [n, 1024] and
   finite, patches/s on the host clock; then each backbone's median ms on
   one resident uint8 batch of 256, Phikon's peak device memory and a
   ``torch.profiler`` split of its batch; then 8 patches on the card against
   the CPU's plain path in fp32 (cosine), and int8 against bf16 (cosine);
7. downstream slice: a synthetic cohort of 48 slides (32 train, 16 val) at
   the templates' full width, in the subtyping class layout, with a split
   and a survival CSV; ``mirror_tpu_torch.train_subtyping.main`` with the
   subtyping template (2 classes, linear probe, warm-started from phase 5's
   ``last.pth.tar``) and ``mirror_tpu_torch.train_survival.main`` with the
   survival template set to fine-tune and ``--pinv-grad exact``, 2 epochs
   of 2 steps each: launch counts read around each run, every logged loss
   finite, the eval metrics finite and in range; each run's step timed on
   one resident batch (ms, peak memory) and profiled; one classifier step
   at batch 2 with the exact gradient on the card against the CPU's plain
   path; ``predict`` scoring the subtyping checkpoint;
8. the kernel self-test: ``mirror_tpu_torch.selftest.main()`` at
   ``bench.py --selftest``'s shapes (NystromAttention dim 512, dh 64, 256
   landmarks on [8, 2117, 512] with the exact and the implicit pinv
   gradient, PPEG on [8, 46, 46, 512], the conv on [8, 8, 2117, 96] with
   fp32 taps), its JSON line printed, every mode true, launch counts read
   around it; then that NystromAttention at batch 2, card against the CPU's
   plain path, in both gradient modes (loss and kernel-fed gradients);
9. the TPU probes: each ``mirror_tpu_torch.scripts.exp_*`` module's
   ``main`` at its script's default shapes (the copy floor on [64, 8, 2304,
   96] and d 128, the conv's passes at [64, 8, 2304, 96] K 33, the LN +
   q/k/v projection at [64, 2117, 768], the exact pinv backward's stash
   variants at [64, 8, 384, 384], the ViT attention layouts and the fused
   ViT sub-layers k5, k7, k8 and k9 at [512, 197, 768]) with fewer reps,
   its rows and JSON line printed, launch counts read around the six, and
   the new kernels' results held again: every copy bit for bit, the conv's
   dv alone bit for bit the fused dv, the attention layouts and the fused
   sub-layers (k8 and k9 also on out - x) within 1e-2 of the plain
   version, the stash variants within 2b's bars of the full stash. Phases
   3 and 3b also hold and time each new kernel at these shapes, and give
   kernels 2 and 2b a library time: their products as batched bf16 cuBLAS
   calls.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
The script imports nothing of JAX.
"""

import json
import logging
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
sys.path.insert(0, str(REPO))
try:
    # the roofline peaks and bound, the error bars and the errors: one copy,
    # the probes' (mirror_tpu_torch/scripts), so both read alike
    from mirror_tpu_torch.scripts._timing import (
        BOUND_BWD, BOUND_PINV_BWD, BOUND_PINV_BWD_COS, BOUND_SINGLE_ROUNDING, PEAK_BYTES,
        bound, events_ms, nbytes, rel_err, sum_bound, sum_err)
except ModuleNotFoundError as e:
    print(f"chip_smoke: FAIL: {e}: run it from a checkout of the repository",
          file=sys.stderr)
    sys.exit(1)

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
SUBTYPING_YAML = REPO / "configs" / "subtyping" / "mirror.template.yaml"
SURVIVAL_YAML = REPO / "configs" / "survival" / "mirror.template.yaml"
# downstream: 48 slides, 32 train (2 steps of 16 an epoch) and 16 val
N_DOWN_SLIDES, N_DOWN_TRAIN, DOWN_EPOCHS = 48, 32, 2
CLASSES = ("LUAD", "LUSC")
N_PRETRAIN_SLIDES, TRAIN_STEPS, TRAIN_STEPS_EXACT = 64, 4, 2
# feature extraction: Phikon ViT-B/16 at 224 px (patch 16: 197 tokens), d 768,
# 12 heads of 64, MLP 3072, depth 12, LN eps 1e-12, batch 256 (the CLI's
# default); 8 synthetic slides of 2,048 patches in all
VIT_B, VIT_N, VIT_D, VIT_HEADS, VIT_MLP, VIT_DEPTH, VIT_EPS = 256, 197, 768, 12, 3072, 12, 1e-12
FEATGEN_SLIDE_SIZES = (200, 312, 256, 180, 300, 264, 240, 296)  # 2048 patches, tails

# The pinv forward's bar on the relative Frobenius error against its plain
# version (the other kernels' bars are the probes', imported above): it
# chains 24 bf16 products whose one-ulp differences the 6 unconverged
# iterations amplify, so 1e-1, and it is also held by function, |x z - I| no
# worse than 1.5x the plain version's.
BOUND_PINV = 1e-1
PINV_ITERS = 6
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
# the self-test's shapes (bench.py::selftest): NystromAttention dim 512, 8
# heads of 64, 256 landmarks on x [8, 2117, 512] (front pad 187, groups of
# 9); PPEG on [8, 46, 46, 512]; the conv on [8, 8, 2117, 96]
SELFTEST_B, SELFTEST_DIM, SELFTEST_DH, SELFTEST_M = 8, 512, 64, 256
SELFTEST_PAD = (SELFTEST_M - N % SELFTEST_M) % SELFTEST_M  # 187
CONV_SELFTEST = (SELFTEST_B, HEADS, N, 96)
# the TPU probes' default shapes (scripts/exp_*.py): the conv and the copy
# on [64, 8, 2304, 96], the ViT attention at batch 512
PROBE_CONV = (64, HEADS, 2304, 96)
PROBE_VIT_B = 512
# the Nystrom kernels' shapes in phases 3 and 3b, (b, n, pad, dh, m): the
# encoder's (the first: it gives the times), the retention decoder's and
# the self-test's
NYSTROM_SHAPES = ((B, N, PAD, DH, M), (B, N_DEC, PAD_DEC, DH, M),
                  (SELFTEST_B, N, SELFTEST_PAD, SELFTEST_DH, SELFTEST_M))
# PPEG's, (b, C): the slices' and the self-test's
PPEG_SHAPES = ((B, EMBED), (SELFTEST_B, SELFTEST_DIM))

FORWARD = ("landmark_softmax", "moore_penrose_pinv", "softmax_attn", "softmax_attn_conv",
           "ppeg")
BACKWARD = ("landmark_softmax_bwd", "softmax_attn_bwd", "softmax_attn_conv_bwd", "ppeg_bwd")
PINV_BWD = "moore_penrose_pinv_bwd"  # kernel 2b: --pinv-grad exact only
PINV_GEMM = "pinv_gemm"  # every launch of kernels 2's and 2b's GEMM
VIT = ("vit_attn_block", "vit_mlp_block", "vit_mha_natural")
SELFTEST_PATH = FORWARD[:4] + BACKWARD[:3] + ("ppeg", "ppeg_bwd", "conv1d", "conv1d_bwd")


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
    # registers, shared memory and spills of the redesigned kernels (-Xptxas -v)
    for src in ("landmark.cu", "landmark_bwd.cu", "softmax_attn.cu", "softmax_attn_bwd.cu",
                "vit_attn.cu", "ppeg.cu", "pinv.cu", "vit_gemm.cu", "copy_floor.cu",
                "vit_fused.cu"):
        info = _common.PTXAS_INFO[src]
        for line in info.splitlines():
            # (C75xx: ptxas's performance warnings, e.g. wgmma serialised or
            # setmaxnreg ignored)
            if any(key in line for key in ("Compiling entry", "Used", "spill", "C75")):
                say(f"[ptxas] {src}: {line.split('info    :')[-1].strip()}")


def median_ms(fn, reps=20, warmup=3):
    """(ms, single-call ms): medians of one call over ``reps`` samples each.
    For the first, a sample is a run of back-to-back calls that lasts about
    2 ms (1 to 50 calls, divided out): for a short kernel the card then
    works through its queue while the host prepares the next launch, and
    the wrapper's host time is not timed as the kernel's. For the second, a
    sample is one call between two events, the wrapper's host work included
    (how the rows were timed before runs of calls). A call of 2 ms or more
    is timed alone, and both are that reading."""
    for _ in range(warmup):
        fn()
    single = statistics.median(events_ms(fn) for _ in range(reps))
    runs = max(1, min(50, math.ceil(2.0 / max(single, 1e-3))))
    if runs == 1:
        return single, single
    return statistics.median(events_ms(fn, runs) for _ in range(reps)), single


def errors(torch, out, ref):
    """[(max abs error, relative Frobenius error)] of each output against
    its reference."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    refs = ref if isinstance(ref, (tuple, list)) else (ref,)
    result = []
    for o, r in zip(outs, refs, strict=True):
        if o.shape != r.shape or not torch.isfinite(o.float()).all():
            fail(f"kernel output shape {tuple(o.shape)} vs {tuple(r.shape)}, or not finite")
        result.append(((o.float() - r.float()).abs().max().item(), rel_err(o, r)))
    return result


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
    (ms, ms_1), (plain_ms, plain_ms_1) = (median_ms(case.kernel),
                                          median_ms(case.plain, reps=10))
    library_ms, library_ms_1 = median_ms(case.library) if case.library else (None, None)
    bound_ms, bound_by = bound(case.work["bytes"], case.work["mma"], case.work.get("fp32", 0))
    # a launch sequence's own floor: the bytes its launches move between
    # them through device memory (the pinv's 24 / 71 launches), from the
    # design's count of tensors (not measured): printed, kept out of the JSON
    design_ms = case.work["design_bytes"] / PEAK_BYTES * 1e3 if "design_bytes" in case.work \
        else None
    # the bytes bound of the same function with other residuals (kernels 1
    # and 1b with the TPU kernel's), printed beside, kept out of the JSON
    alt = case.work.get("alt_bytes")
    per_output = ", ".join(f"{o} {a:.4g}/{r:.4g}" for o, (a, r) in zip(case.outputs, errs))
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    lib_1 = f", library {library_ms_1:.4f}" if library_ms is not None else ""
    # achieved rate: the tensor-core operations the function needs over the
    # kernel's time; `products`: the r c dh products the design runs / the
    # function needs, as the source notes count them (not measured)
    tflops = case.work["mma"] / ms / 1e9 if case.work["mma"] else None
    ratio = ms / library_ms if library_ms else None
    rate = f"; {tflops:.1f} TFLOP/s" if tflops is not None else ""
    if "products" in case.work:
        rate += (f", {case.work['products'][0]} products run by the design "
                 f"({case.work['products'][1]} needed)")
    if ratio is not None:
        rate += f", kernel / library {ratio:.2f}"
    rate += f", {100 * bound_ms / ms:.1f} % of its bound"
    if design_ms is not None:
        rate += f"; the design's bytes floor {design_ms:.4f} ms ({100 * design_ms / ms:.1f} %)"
    if alt is not None:
        rate += f"; with {alt[0]} the bound is {alt[1] / PEAK_BYTES * 1e3:.4f} ms by bytes"
    say(f"[kernel] {case.name} ({case.shape}): max abs / rel Frobenius err {per_output} "
        f"(bound {case.tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, "
        f"bound {bound_ms:.4f} ms by {bound_by}{rate} (medians of warm calls, runs of calls "
        f"under 2 ms; single calls: kernel {ms_1:.4f}, plain {plain_ms_1:.4f}{lib_1})")
    if not ok:
        fail(f"{case.name} ({case.shape}) disagrees with its plain version beyond its bound")
    sources = [f"mirror_tpu_torch/csrc/{f}"
               for f in (case.src if isinstance(case.src, tuple) else (case.src,))]
    return dict(name=case.name, route="cuda", source=sources[0], sources=sources,
                replaces=case.replaces, shape=case.shape,
                max_abs_err=max(a for a, _ in errs), rel_fro_err=max(r for _, r in errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, ms_single_call=ms_1, plain_ms_single_call=plain_ms_1,
                library_ms_single_call=library_ms_1, tflops=tflops, library_ratio=ratio)


def forward_cases(torch, randn):
    from mirror_tpu_torch.ops import landmark, nystrom_attn, pinv, ppeg

    import torch.nn.functional as F

    bf16 = torch.bfloat16
    cases = []
    for b, n, pad, dh, m in NYSTROM_SHAPES:
        bh = b * HEADS
        shape = f"b {b}, h {HEADS}, n {n}, pad {pad}, dh {dh}, m {m}"
        q = randn(b, HEADS, n, dh, scale=dh ** -0.5)
        k, v = randn(b, HEADS, n, dh), randn(b, HEADS, n, dh)
        q_l, k_l, attn2 = landmark.landmark_softmax_ref(q, k, m, pad)
        lse_bytes = 4 * bh * m  # the forward's fp32 row log-sum-exp
        w = randn(b, HEADS, m, dh)
        kern = randn(HEADS, CONV_TAPS, scale=CONV_TAPS ** -0.5)
        attn_mma = 4 * bh * n * m * dh  # S = q k^T and P w
        conv_fp32 = 2 * bh * n * dh * CONV_TAPS
        # kernel 3's function as one PyTorch call: its pad columns are
        # zero logits with zero w rows, so SDPA on explicitly zero-padded k
        # and w (built here, outside the timed call) computes it
        k_pad = torch.cat([k.new_zeros(b, HEADS, pad, dh), k], dim=2)
        v_pad = torch.cat([v.new_zeros(b, HEADS, pad, dh), v], dim=2)
        # kernel 1 on its launch wrapper with the fp32 row log-sum-exp it
        # keeps for the backward (as kernel 2b below): through the autograd
        # Function a call at the self-test's shape is host-bound
        cases.append(Case(
            "landmark_softmax", "landmark.cu", "mirror_tpu/ops/landmark_pallas.py:183", shape,
            lambda q=q, k=k, m=m, pad=pad: landmark._launch_fwd(q, k, m, pad),
            lambda q=q, k=k, m=m, pad=pad: landmark.landmark_softmax_lse_ref(q, k, m, pad),
            BOUND_SINGLE_ROUNDING, ("q_l", "k_l", "attn2", "lse"),
            dict(bytes=nbytes(q, k, q_l, k_l, attn2) + lse_bytes, mma=2 * bh * m * m * dh,
                 alt_bytes=("the TPU kernel's outputs (no lse)",
                            nbytes(q, k, q_l, k_l, attn2)))))
        cases.append(Case(
            "softmax_attn", "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:202",
            f"kv: r {m}, c {n}, pad {pad}, b {b}, dh {dh}",
            lambda q_l=q_l, k=k, v=v, pad=pad:
                nystrom_attn.softmax_matmul_landmark_kv(q_l, k, v, pad),
            lambda q_l=q_l, k=k, v=v, pad=pad:
                nystrom_attn.softmax_attn_ref(q_l, k, v, pad).to(bf16),
            BOUND_SINGLE_ROUNDING, ("out",),
            dict(bytes=nbytes(q_l, k, v, q_l), mma=attn_mma, products=(2, 2)),
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
            dict(bytes=nbytes(q, k_l, w, v, kern, q), mma=attn_mma, fp32=conv_fp32,
                 products=(2, 2))))
        if n != N:
            continue
        s = pinv.global_scale(attn2)

        def pinv_check(z, z_ref, x=attn2, m=m):
            # held by function too: |x z - I| no worse than 1.5x the plain
            # version's (or 0.05)
            eye = torch.eye(m, device=x.device)
            err = (x.float() @ z.float() - eye).abs().max().item()
            err_ref = (x.float() @ z_ref.float() - eye).abs().max().item()
            say(f"[kernel] moore_penrose_pinv (m {m}): |x z - I| max {err:.4g} "
                f"(plain {err_ref:.4g})")
            return err <= max(1.5 * err_ref, 0.05)

        cases.append(Case(
            "moore_penrose_pinv", "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:239",
            f"b {b}, h {HEADS}, m {m}", lambda x=attn2: pinv.moore_penrose_pinv(x),
            lambda x=attn2, s=s: pinv.pinv_iterations_ref(x, s), BOUND_PINV, ("z",),
            dict(bytes=2 * nbytes(attn2), mma=6 * 4 * 2 * bh * m ** 3,
                 design_bytes=pinv_design_units(PINV_ITERS) * nbytes(attn2)), check=pinv_check,
            library=lambda x=attn2, s=s: pinv_library(torch, x, s, PINV_ITERS)))
        if dh != DH:  # the q variant has no caller: the slices' shape only
            continue
        cases.append(Case(
            "softmax_attn_q", "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:208",
            f"q: r {n}, c {m}, pad 0",
            lambda q=q, k_l=k_l, w=w: nystrom_attn.softmax_matmul_landmark_q(q, k_l, w),
            lambda q=q, k_l=k_l, w=w: nystrom_attn.softmax_attn_ref(q, k_l, w).to(bf16),
            BOUND_SINGLE_ROUNDING, ("out",),
            dict(bytes=nbytes(q, k_l, w, q), mma=attn_mma, products=(2, 2)),
            library=lambda q=q, k_l=k_l, w=w:
                F.scaled_dot_product_attention(q, k_l, w, scale=1.0)))

    for b, c in PPEG_SHAPES:
        img = randn(b, SIDE, SIDE, c)
        ppeg_k, ppeg_b = randn(7, 7, c, scale=0.1), randn(c, scale=0.1)
        # PPEG as one depthwise conv: the identity folded into the centre tap
        conv_w = ppeg_k.permute(2, 0, 1).unsqueeze(1).clone()  # [C, 1, 7, 7]
        conv_w[:, 0, 3, 3] += 1
        img_nchw = img.permute(0, 3, 1, 2)  # a channels-last view
        cases.append(Case(
            "ppeg", "ppeg.cu", "mirror_tpu/ops/ppeg_pallas.py:179", f"[{b}, {SIDE}, {SIDE}, {c}]",
            lambda img=img, k=ppeg_k, bias=ppeg_b: ppeg.ppeg_fused(img, k, bias),
            lambda img=img, k=ppeg_k, bias=ppeg_b: ppeg.ppeg_ref(img, k, bias),
            BOUND_SINGLE_ROUNDING, ("out",),
            dict(bytes=nbytes(img, ppeg_k, ppeg_b, img), mma=0, fp32=(2 * 49 + 2) * img.numel()),
            library=lambda img_nchw=img_nchw, conv_w=conv_w, bias=ppeg_b, c=c: F.conv2d(
                img_nchw, conv_w, bias, padding=3, groups=c)))
    return cases + pinv_gemm_cases(torch, randn) + vit_cases(torch, randn) \
        + conv_cases(torch, randn, False) + [ln_qkv_case(torch, randn, False)] \
        + probe_cases(torch, randn, False)


def sum_check(torch, name, outputs, indices):
    """A ``check`` that holds outputs ``indices`` (batch sums) by max abs
    error against the plain version's largest magnitude."""
    def check(out, ref):
        ok = True
        for i in indices:
            bound, rel = sum_bound(out[i]), sum_err(out[i], ref[i])
            say(f"[kernel] {name}: {outputs[i]} max abs err / largest magnitude {rel:.4g} "
                f"(bound {bound:g})")
            ok = ok and rel <= bound
        return ok
    return check


def conv_cases(torch, randn, backward: bool):
    """Kernel 9 (9b) at the slice's [16, 8, 2117, 96] with bf16 taps and at
    the self-test's [8, 8, 2117, 96] with fp32 taps."""
    import torch.nn.functional as F

    from mirror_tpu_torch.ops import conv1d

    cases = []
    for shape, taps in (((B, HEADS, N, DH), torch.bfloat16), (CONV_SELFTEST, torch.float32)):
        v = randn(*shape)
        h, ksize = shape[1], CONV_TAPS
        kern = randn(h, ksize, scale=0.1, dtype=taps)
        kern16 = kern.to(torch.bfloat16)  # the taps the kernel takes
        weight = kern16.view(h, 1, ksize, 1)
        label = f"v {list(shape)}, K {ksize}, {str(taps).split('.')[-1]} taps"
        fmas = 2 * ksize * v.numel()
        if not backward:
            cases.append(Case(
                "conv1d", "conv1d.cu", "mirror_tpu/ops/conv1d_pallas.py:258", label,
                lambda v=v, kern=kern: conv1d.depthwise_conv1d_seq(v, kern),
                lambda v=v, kern16=kern16: conv1d.depthwise_conv_seq_ref(v, kern16).to(v.dtype),
                BOUND_SINGLE_ROUNDING, ("out",),
                dict(bytes=nbytes(v, kern, v), mma=0, fp32=fmas),
                library=lambda v=v, weight=weight, h=h: F.conv2d(
                    v, weight, padding=(CONV_TAPS // 2, 0), groups=h)))
            continue
        g = randn(*shape)
        cases.append(Case(
            "conv1d_bwd", "conv1d.cu", "mirror_tpu/ops/conv1d_pallas.py:224", label,
            autograd_kernel(torch, conv1d.depthwise_conv1d_seq, (v, kern), (g,)),
            lambda v=v, kern16=kern16, g=g: conv1d.depthwise_conv_seq_bwd_ref(v, kern16, g),
            BOUND_BWD, ("dv", "dkern"),
            dict(bytes=nbytes(v, kern, g, v, kern), mma=0, fp32=2 * fmas),
            library=lambda v=v, weight=weight, g=g, h=h: torch.ops.aten.convolution_backward(
                g, v, weight, None, [1, 1], [CONV_TAPS // 2, 0], [1, 1], False, [0, 0], h,
                [True, True, False]),
            check=sum_check(torch, "conv1d_bwd", ("dv", "dkern"), (1,))))
    return cases


def ln_qkv_case(torch, randn, backward: bool):
    """Kernel 10 (10b) at x [16, 2117, 768], 8 heads of 96, eps 1e-5; the
    library yardstick is two calls, ``layer_norm`` and a cuBLAS ``matmul``
    with the head-major view (autograd for the backward)."""
    import torch.nn.functional as F

    from mirror_tpu_torch.ops import ln_qkv

    f32 = torch.float32
    x = randn(B, N, EMBED)
    ln_s, ln_b = 1.0 + randn(EMBED, scale=0.1, dtype=f32), randn(EMBED, scale=0.1, dtype=f32)
    w = randn(EMBED, 3 * HEADS * DH, scale=EMBED ** -0.5)
    s16, b16 = ln_s.to(torch.bfloat16), ln_b.to(torch.bfloat16)
    rows, n3 = B * N, 3 * HEADS * DH
    label = f"x [{B}, {N}, {EMBED}], heads {HEADS}, dh {DH}"

    def two_calls(x, s, b, w):
        y = F.layer_norm(x, (EMBED,), s, b, 1e-5) @ w
        return y.view(B, N, 3, HEADS, DH).permute(2, 0, 3, 1, 4).unbind(0)

    def fused(x, s, b, w):
        return ln_qkv.ln_qkv_fused(x, s, b, w, HEADS)

    qkv_bytes = 3 * nbytes(x) // EMBED * HEADS * DH
    if not backward:
        return Case(
            "ln_qkv", "ln_qkv.cu", "mirror_tpu/ops/ln_qkv_pallas.py:213", label,
            lambda: fused(x, ln_s, ln_b, w), lambda: ln_qkv.ln_qkv_ref(x, ln_s, ln_b, w, HEADS),
            BOUND_SINGLE_ROUNDING, ("q", "k", "v"),
            dict(bytes=nbytes(x, ln_s, ln_b, w) + qkv_bytes, mma=2 * rows * EMBED * n3,
                 fp32=8 * rows * EMBED),
            library=lambda: two_calls(x, s16, b16, w))
    g = tuple(randn(B, HEADS, N, DH) for _ in range(3))

    def plain():  # in the Function's gradient order: x, s, b, w
        gx, gw, gs, gb = ln_qkv.ln_qkv_bwd_ref(x, ln_s, ln_b, w, *g, HEADS)
        return gx, gs, gb, gw

    return Case(
        "ln_qkv_bwd", "ln_qkv.cu", "mirror_tpu/ops/ln_qkv_pallas.py:157", label,
        autograd_kernel(torch, fused, (x, ln_s, ln_b, w), g), plain, BOUND_BWD,
        ("gx", "gs", "gb", "gw"),
        dict(bytes=2 * nbytes(x, ln_s, ln_b, w) + qkv_bytes, mma=4 * rows * EMBED * n3,
             fp32=16 * rows * EMBED),
        library=autograd_kernel(torch, two_calls, (x, s16, b16, w), g),
        check=sum_check(torch, "ln_qkv_bwd", ("gx", "gs", "gb", "gw"), (1, 2, 3)))


def added_term(name, x):
    """A check that holds what a half-block adds to x, out - x, against the
    plain version's: x passes through unchanged and dominates the output
    (~8x the added term at phase 3's ViT scales, ~50x at the fused probe's),
    so the whole output alone would dilute a fault there."""
    def check(out, ref):
        xf = x.float()
        rel = rel_err(out.float() - xf, ref.float() - xf)
        say(f"[kernel] {name}: out - x rel Frobenius err {rel:.4g} "
            f"(bound {BOUND_SINGLE_ROUNDING:g})")
        return rel <= BOUND_SINGLE_ROUNDING
    return check


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

    attn_mma = 4 * b * h * n * n * dh  # q k^T and P v
    softmax_fp32 = 5 * b * h * n * n  # scale, max, exp, sum, divide
    ln_fp32 = 10 * rows * d  # statistics and the affine, the residual add
    shape = f"b {b}, n {n}, d {d}, heads {h}"
    # the PyTorch calls for the same two functions (bf16 LN scale, shift and
    # biases: layer_norm and addmm take x's dtype), timed beside them only
    s16, lb16 = ln_s.to(x.dtype), ln_b.to(x.dtype)
    wqkv = torch.cat([wq, wk, wv], dim=1)
    bqkv16, bo16 = attn_args[6].to(x.dtype), attn_args[8].to(x.dtype)
    b1_16, b2_16 = mlp_args[4].to(x.dtype), mlp_args[6].to(x.dtype)

    def attn_block_library():
        y = F.layer_norm(x, (d,), s16, lb16, VIT_EPS).view(rows, d)
        qkv = torch.addmm(bqkv16, y, wqkv).view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return x + torch.addmm(bo16, o.transpose(1, 2).reshape(rows, d), wo).view(b, n, d)

    def mlp_block_library():
        y = F.layer_norm(x, (d,), s16, lb16, VIT_EPS).view(rows, d)
        hid = F.gelu(torch.addmm(b1_16, y, mlp_args[3]), approximate="none")
        return x + torch.addmm(b2_16, hid, mlp_args[5]).view(b, n, d)

    return vit_gemm_cases(torch, randn, x, ln_s, ln_b) + [
        Case("vit_attn_block", ("vit_gemm.cu", "vit_attn.cu"),
             "mirror_tpu/ops/vit_attn_pallas.py:255", shape,
             lambda: vit_attn.attn_block(*attn_args, h, VIT_EPS),
             lambda: vit_attn.attn_block_ref(*attn_args, h, VIT_EPS),
             BOUND_SINGLE_ROUNDING, ("out",),
             dict(bytes=nbytes(*attn_args, x), mma=2 * rows * d * 4 * d + attn_mma,
                  fp32=softmax_fp32 + ln_fp32), library=attn_block_library,
             check=added_term("vit_attn_block", x)),
        Case("vit_mlp_block", "vit_gemm.cu", "mirror_tpu/ops/vit_attn_pallas.py:276",
             f"{shape}, mlp {m}", lambda: vit_attn.mlp_block(*mlp_args, VIT_EPS),
             lambda: vit_attn.mlp_block_ref(*mlp_args, VIT_EPS), BOUND_SINGLE_ROUNDING, ("out",),
             dict(bytes=nbytes(*mlp_args, x), mma=4 * rows * d * m,
                  fp32=10 * rows * m + ln_fp32),  # bias and the erf GELU
             library=mlp_block_library, check=added_term("vit_mlp_block", x)),
        Case("vit_mha_natural", "vit_attn.cu", "mirror_tpu/ops/vit_attn_pallas.py:242", shape,
             lambda: vit_attn.mha_natural(q, k, v, h),
             lambda: vit_attn.mha_natural_ref(q, k, v, h), BOUND_SINGLE_ROUNDING, ("out",),
             dict(bytes=4 * nbytes(q), mma=attn_mma, fp32=softmax_fp32),
             library=lambda: F.scaled_dot_product_attention(by_head(q), by_head(k), by_head(v))),
    ]


def vit_gemm_cases(torch, randn, x, ln_s, ln_b):
    """The LN pass and the projection GEMM of kernels 6 and 7 (``vit_gemm.cu``),
    each launch alone at Phikon's shapes (M = 256 x 197 rows): the q|k|v
    product [M, 768] x [768, 2304] + bias (the first: it gives the row's
    times), fc1 [M, 768] x [768, 3072] + bias then GELU, fc2 [M, 3072] x
    [3072, 768] and the output projection [M, 768] x [768, 768], + bias then
    + x. The library yardstick is one ``torch.addmm(bias, y, W)`` on the same
    operands, a yardstick that does less: no GELU, no residual, a bf16 bias.
    The LN pass's is ``F.layer_norm`` (bf16 scale and bias)."""
    import torch.nn.functional as F

    from mirror_tpu_torch.ops import vit_attn as va

    d, m, rows = VIT_D, VIT_MLP, VIT_B * VIT_N
    y = torch.empty_like(x)
    s16, b16 = ln_s.to(x.dtype), ln_b.to(x.dtype)  # layer_norm takes x's dtype
    cases = [Case(
        "vit_ln", "vit_gemm.cu", "mirror_tpu/ops/vit_attn_pallas.py:103", f"[{rows}, {d}]",
        lambda: (va._launch_ln(x, ln_s, ln_b, VIT_EPS, y), y)[1],
        lambda: va._ln_ref(x, ln_s, ln_b, VIT_EPS), BOUND_SINGLE_ROUNDING, ("y",),
        dict(bytes=nbytes(x, ln_s, ln_b, y), mma=0, fp32=8 * rows * d),
        library=lambda: F.layer_norm(x, (d,), s16, b16, VIT_EPS))]
    forms = (("q|k|v + bias", 110, d, 3 * d, va._EPI_BIAS),
             ("fc1 + bias, GELU", 194, d, m, va._EPI_BIAS_GELU),
             ("fc2 + bias + x", 194, m, d, va._EPI_BIAS_RESIDUAL),
             ("out projection + bias + x", 110, d, d, va._EPI_BIAS_RESIDUAL))
    for what, line, k, n, epi in forms:
        a = randn(VIT_B, VIT_N, k)
        w = randn(k, n, scale=k ** -0.5)
        bias = randn(n, scale=0.1).float()
        resid = x if epi == va._EPI_BIAS_RESIDUAL else None
        out, plain_out = (torch.empty(VIT_B, VIT_N, n, dtype=x.dtype, device=x.device)
                          for _ in range(2))
        a2, bias16 = a.view(rows, k), bias.to(x.dtype)
        # bias and, for GELU, its ~20 operations an element (erf's polynomial)
        epi_fp32 = rows * n * (20 if epi == va._EPI_BIAS_GELU else 2)
        cases.append(Case(
            "vit_gemm", "vit_gemm.cu", f"mirror_tpu/ops/vit_attn_pallas.py:{line}",
            f"{what}: [{rows}, {k}] x [{k}, {n}]",
            lambda a=a, w=w, bias=bias, out=out, epi=epi, resid=resid:
                (va._launch_gemm(a, w, bias, out, epi, resid=resid), out)[1],
            lambda a=a, w=w, bias=bias, out=plain_out, epi=epi, resid=resid:
                (va.gemm_ref(a, w, bias, out, epi, resid=resid), out)[1],
            BOUND_SINGLE_ROUNDING, ("c",),
            dict(bytes=nbytes(a, w, bias, out) + (nbytes(resid) if resid is not None else 0),
                 mma=2 * rows * k * n, fp32=epi_fp32),
            library=lambda a2=a2, w=w, bias16=bias16: torch.addmm(bias16, a2, w)))
    return cases


def pinv_design_units(iters, stash=None):
    """[b, h, m, m] bf16 tensors that the pinv's launch sequence moves
    through device memory (each launch reads its operands and writes its
    outputs; an fp32 tensor counts 2): the forward (``stash`` None) or the
    exact backward keeping ``stash`` of the replay's 4 products. Forward:
    z0 (read x, write z0) and per iteration x z -> xz, t1 (4), xz t1 -> t3
    (3), xz t3 -> a (3), z a -> z' (3). Backward: the replay (the last z'
    skipped), g's copy (2), gx32's zeros (2), per sweep step t1 = 7I - xz
    (2; with stash 1 x z -> xz, t1, 4), the recomputed t3 and a (3 each,
    stash 1 and 2), 4 products of 3, 3 with ``prev`` (4), gx32 += gb z^T
    (2 + 4), and the finish (gx32 2, gz 2, z0 1, gx 1)."""
    fwd = 2 + 13 * iters
    if stash is None:
        return fwd
    sweep = {4: 2, 2: 2 + 6, 1: 4 + 6}[stash] + 4 * 3 + 3 * 4 + 6
    return fwd - 3 + 2 + 2 + iters * sweep + 6


def pinv_gemm_cases(torch, randn):
    """One launch of the pinv's GEMM at the slice's [b h, m, m] = [128, 384,
    384], in the four forms the pinv launches most: the forward's x z with
    7I - xz (NN, EYE and c2), the sweep's gb += (NN here, ADD), gx += gb z^T
    (TN here, ACC32) and gz' = 0.25 gz a^T (NT, EYE), each against its
    plain version (``gemm_ref``) and one cuBLAS call on the same views. The
    bound is its bytes over the bandwidth: every launch is bound by them."""
    from mirror_tpu_torch.ops import pinv

    bh, m = B * HEADS, M
    a, b = randn(bh, m, m), randn(bh, m, m)
    c, c2, prev = (torch.empty_like(a) for _ in range(3))
    prev.copy_(randn(bh, m, m))
    acc0 = randn(bh, m, m, dtype=torch.float32)
    acc = acc0.clone()
    shape = f"[{bh}, {m}, {m}]"
    mma = 2 * bh * m ** 3

    def run(fn, *outs):
        def call():
            fn()
            return outs if len(outs) > 1 else outs[0]
        return call

    def plain(**kw):
        outs = [torch.empty_like(a) for _ in range(2)]
        accp = acc0.clone()
        if kw.get("epilogue") == pinv._ACC32:
            return run(lambda: pinv.gemm_ref(a, b, acc=accp.copy_(acc0), **kw), accp)
        if kw.get("c2"):
            kw["c2"] = outs[1]
            return run(lambda: pinv.gemm_ref(a, b, outs[0], **kw), *outs)
        return run(lambda: pinv.gemm_ref(a, b, outs[0], **kw), outs[0])

    return [
        Case("pinv_gemm", "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:151", f"{shape} NN/EYE+c2",
             run(lambda: pinv._launch_gemm(a, b, c, c2, d0=7.0, d1=-1.0), c, c2),
             plain(c2=True, d0=7.0, d1=-1.0), BOUND_SINGLE_ROUNDING, ("xz", "t1"),
             dict(bytes=4 * nbytes(a), mma=mma), library=lambda: torch.bmm(a, b)),
        Case("pinv_gemm", "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:171", f"{shape} NN/ADD",
             run(lambda: pinv._launch_gemm(a, b, c, prev=prev, epilogue=pinv._ADD), c),
             plain(prev=prev, epilogue=pinv._ADD), BOUND_SINGLE_ROUNDING, ("c",),
             dict(bytes=4 * nbytes(a), mma=mma), library=lambda: torch.baddbmm(prev, a, b)),
        # the kernel's acc holds acc0 + P after its first call (the one
        # compared); the timed calls go on adding to it
        Case("pinv_gemm", "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:171", f"{shape} TN/ACC32",
             run(lambda: pinv._launch_gemm(a, b, acc=acc, layout=pinv._TN,
                                           epilogue=pinv._ACC32), acc),
             plain(layout=pinv._TN, epilogue=pinv._ACC32), BOUND_SINGLE_ROUNDING, ("acc",),
             dict(bytes=2 * nbytes(a) + 2 * nbytes(acc), mma=mma),
             library=lambda: torch.bmm(a.mT, b)),  # bf16 out: the fp32 sum not included
        Case("pinv_gemm", "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:171", f"{shape} NT/EYE",
             run(lambda: pinv._launch_gemm(a, b, c, layout=pinv._NT, c1=0.25), c),
             plain(layout=pinv._NT, c1=0.25), BOUND_SINGLE_ROUNDING, ("c",),
             dict(bytes=3 * nbytes(a), mma=mma),
             library=lambda: torch.baddbmm(c, a, b.mT, beta=0.0, alpha=0.25)),
    ]


def pinv_library(torch, x, s, iters):
    """Kernel 2's products as batched bf16 cuBLAS calls (fp32 accumulation),
    the eye terms in their epilogues (``baddbmm``): the yardstick of R1."""
    m = x.shape[-1]
    xb = x.reshape(-1, m, m)
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    z = (xb.mT.float() / s).to(x.dtype)
    for _ in range(iters):
        xz = torch.bmm(xb, z)
        t1 = 7.0 * eye - xz
        t3 = torch.baddbmm(15.0 * eye, xz, t1, alpha=-1.0)
        a = torch.baddbmm(13.0 * eye, xz, t3, alpha=-1.0)
        z = torch.bmm(z, a) * 0.25
    return z.view_as(x)


def pinv_bwd_library(torch, x, s, g, iters):
    """Kernel 2b's 71 products (the replay, its last z product skipped, and
    the sweep) as batched bf16 cuBLAS calls on transposed views, gx summed in
    fp32 from bf16 products."""
    m = x.shape[-1]
    xb, gz = x.reshape(-1, m, m), g.reshape(-1, m, m)
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    z = (xb.mT.float() / s).to(x.dtype)
    z0, kept = z, []
    for t in range(iters):
        xz = torch.bmm(xb, z)
        t1 = 7.0 * eye - xz
        t3 = torch.baddbmm(15.0 * eye, xz, t1, alpha=-1.0)
        a = torch.baddbmm(13.0 * eye, xz, t3, alpha=-1.0)
        kept.append((z, xz, t1, t3, a))
        if t + 1 < iters:
            z = torch.bmm(z, a) * 0.25
    gx = torch.zeros(xb.shape, dtype=torch.float32, device=x.device)
    for z, xz, t1, t3, a in reversed(kept):
        gt4 = torch.bmm(z.mT, gz) * -0.25
        gz_next = torch.bmm(gz, a.mT) * 0.25
        gb = torch.bmm(gt4, t3.mT)
        gt2 = -torch.bmm(xz.mT, gt4)
        gb = torch.baddbmm(gb, gt2, t1.mT)
        gb = torch.baddbmm(gb, xz.mT, gt2, alpha=-1.0)
        gx += torch.bmm(gb, z.mT)
        gz = torch.baddbmm(gz_next, xb.mT, gb)
    gs = -(gz.float() * z0.float()).sum() / s
    return (gx + gz.mT.float() / s).to(x.dtype).view_as(x), gs


def probe_cases(torch, randn, backward: bool):
    """The kernels the TPU probes added (mirror_tpu_torch/scripts), at the
    probes' default shapes: the copy floor ([64, 8, 2304, 96], gb 8), the
    ViT attention on head-major pairs (8 a block) and on the natural layout
    (2 images a block) at [512, 197, 768]; backward: the conv backward's dv
    alone and its column sum alone ([64, 8, 2304, 96], K 33). The exact
    pinv backward's stash variants are 2b's neighbours in
    ``backward_cases``."""
    import torch.nn.functional as F

    from mirror_tpu_torch.ops import conv1d, copy_floor, vit_attn

    cases = []
    if not backward:
        v = randn(*PROBE_CONV)
        dst = torch.empty_like(v)
        cases.append(Case(
            "copy_floor", "copy_floor.cu", "scripts/exp_hbm_floor.py:54", f"{list(v.shape)}, gb 8",
            lambda: copy_floor.copy_floor(v, 8), lambda: copy_floor.copy_floor_ref(v), 0.0,
            ("out",), dict(bytes=2 * nbytes(v), mma=0), library=lambda: dst.copy_(v),
            check=lambda out, ref: bool(torch.equal(out, ref))))
        b, n, h, dh = PROBE_VIT_B, VIT_N, VIT_HEADS, VIT_D // VIT_HEADS
        q, k, w = (randn(b, n, VIT_D) for _ in range(3))
        qz, kz, wz = (t.view(b, n, h, dh).transpose(1, 2).reshape(b * h, n, dh) for t in (q, k, w))
        work = dict(bytes=4 * nbytes(q), mma=4 * b * h * n * n * dh, fp32=5 * b * h * n * n)
        cases.append(Case(
            "vit_mha_headmajor", "vit_attn.cu", "scripts/exp_vit_attn_kernel.py:101",
            f"[{b * h}, {n}, {dh}], 8 pairs a block", lambda: vit_attn.mha_headmajor(qz, kz, wz, 8),
            lambda: vit_attn.mha_headmajor_ref(qz, kz, wz), BOUND_SINGLE_ROUNDING, ("out",), work,
            library=lambda: F.scaled_dot_product_attention(
                *(t.view(b, h, n, dh) for t in (qz, kz, wz)))))
        cases.append(Case(
            "vit_mha_natural_grouped", "vit_attn.cu", "scripts/exp_vit_attn_kernel.py:149",
            f"[{b}, {n}, {VIT_D}], heads {h}, 2 images a block",
            lambda: vit_attn.mha_natural(q, k, w, h, 2),
            lambda: vit_attn.mha_natural_ref(q, k, w, h), BOUND_SINGLE_ROUNDING, ("out",), work,
            library=lambda: F.scaled_dot_product_attention(
                *(t.view(b, n, h, dh).transpose(1, 2) for t in (q, k, w)))))
        return cases + fused_cases(torch)
    v, g = randn(*PROBE_CONV), randn(*PROBE_CONV)
    h = PROBE_CONV[1]
    taps = randn(h, CONV_TAPS, scale=0.1)
    dv, dkern = torch.empty_like(v), torch.empty(h, CONV_TAPS, device=v.device)
    partial = conv1d.conv1d_bwd_scratch(v, CONV_TAPS)
    conv1d.conv1d_bwd_into(v, taps, g, dv, dkern, partial)  # the fused pass's dv and partials
    label = f"{list(v.shape)}, K {CONV_TAPS}"
    cases.append(Case(
        "conv1d_bwd_dv", "conv1d.cu", "scripts/exp_conv_parts.py:55", label,
        lambda: conv1d.conv1d_bwd_dv(g, taps), lambda: conv1d.conv1d_bwd_dv_ref(g, taps),
        BOUND_BWD, ("dv",), dict(bytes=2 * nbytes(v), mma=0, fp32=2 * CONV_TAPS * v.numel()),
        library=lambda: torch.ops.aten.convolution_backward(
            g, v, taps.view(h, 1, CONV_TAPS, 1), None, [1, 1], [CONV_TAPS // 2, 0], [1, 1],
            False, [0, 0], h, [True, False, False])[0],
        # bit for bit the fused kernel's dv
        check=lambda out, ref: bool(torch.equal(out, dv))))
    cases.append(Case(
        "column_sum", "conv1d.cu", "scripts/exp_conv_parts.py:55",
        f"{list(partial.shape)} fp32 partials of {label}", lambda: conv1d.column_sum(partial),
        lambda: conv1d.column_sum_ref(partial), BOUND_SINGLE_ROUNDING, ("dkern",),
        dict(bytes=nbytes(partial) + 4 * partial.shape[1], mma=0, fp32=partial.numel()),
        library=lambda: partial.sum(0),
        # bit for bit the fused kernel's dkern
        check=lambda out, ref: bool(torch.equal(out, dkern.reshape(-1)))))
    return cases


def fused_cases(torch):
    """The fused ViT sub-layers of the probe exp_vit_fused_sublayer (k5, k7,
    k8, k9) at its shapes, x [512, 197, 768], 12 heads, MLP 3072, with its
    weights, G 1: against their plain versions (and k8, k9 on out - x),
    beside the PyTorch calls for the same function (matmul, SDPA, gelu,
    layer_norm)."""
    from mirror_tpu_torch.scripts import exp_vit_fused_sublayer as probe

    from mirror_tpu_torch.ops import vit_fused

    dev = torch.device("cuda")
    wts = probe.make_weights(dev, SEED)
    x = probe.T.randn(dev, PROBE_VIT_B, probe.N, probe.D, seed=SEED + 1)
    shape = f"[{PROBE_VIT_B}, {probe.N}, {probe.D}], heads {probe.H}"
    # the fused attention's CTA mapping at the probe's shape, and how many
    # of its clusters the card holds at once
    hpc = vit_fused.heads_per_cta(probe.N, probe.DH, probe.H)
    say(f"[vit_fused] attention: {hpc} heads a CTA, clusters of {probe.H // hpc}, "
        f"{vit_fused.max_clusters(probe.N, probe.DH, probe.H, 0)} at once")
    say(f"[vit_fused] MLP: clusters of two quads of CTAs (two fc1, two fc2), "
        f"{vit_fused.mlp_clusters(0)} at once")
    cases = []
    for name, group, variant, line in (("vit_fused_attn", "attn", "k5g1", 111),
                                       ("vit_fused_mlp", "mlp", "k7g1", 167),
                                       ("vit_fused_attn_block", "attn_blk", "k8g1", 256),
                                       ("vit_fused_mlp_block", "mlp_blk", "k9g1", 300)):
        fn = probe.VARIANTS[variant][1]
        cases.append(Case(
            name, "vit_fused.cu", f"scripts/exp_vit_fused_sublayer.py:{line}",
            shape if group.startswith("attn") else f"{shape}, mlp {probe.MLP}",
            lambda fn=fn: fn(x, wts), lambda group=group: probe.PLAIN[group](x, wts),
            BOUND_SINGLE_ROUNDING, ("out",), probe.work(group, PROBE_VIT_B, wts),
            library=lambda group=group: probe.VARIANTS[f"library_{group}"][1](x, wts),
            check=added_term(name, x) if group.endswith("_blk") else None))
    return cases


def autograd_kernel(torch, fn, inputs, grads):
    """A callable that runs only the backward of ``fn`` (the kernel behind
    its autograd Function) for the incoming ``grads``: the forward runs
    once here, and its graph is kept for repeated calls."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return lambda: torch.autograd.grad(outs, leaves, grads, retain_graph=True)


def same_bits_check(torch, name, kernel):
    """A ``check`` that runs ``kernel`` a second time on the same inputs and
    holds every output to the first run's bits (the attention and PPEG
    backwards: fixed-order sums, no float atomics)."""
    def check(out, ref):
        again = kernel()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        say(f"[kernel] {name}: two runs {'bit-identical' if same else 'DIFFER'}")
        return same
    return check


def backward_cases(torch, randn):
    import torch.nn.functional as F

    from mirror_tpu_torch.ops import landmark, nystrom_attn, pinv, ppeg

    cases = []
    for b, n, pad, dh, m in NYSTROM_SHAPES:
        bh = b * HEADS
        shape = f"b {b}, h {HEADS}, n {n}, pad {pad}, dh {dh}, m {m}"
        q = randn(b, HEADS, n, dh, scale=dh ** -0.5)
        k, v = randn(b, HEADS, n, dh), randn(b, HEADS, n, dh)
        q_l, k_l, _ = landmark.landmark_softmax_ref(q, k, m, pad)
        gql, gkl, ga2 = randn(b, HEADS, m, dh), randn(b, HEADS, m, dh), randn(b, HEADS, m, m)
        dq = landmark.landmark_softmax_bwd_ref(q, k, m, pad, gql, gkl, ga2)[0]
        # kernel 1b on its launch wrapper, from the card's forward residuals
        # (q_l, k_l and the fp32 lse), as kernel 2b: a call through
        # autograd.grad is host-bound (0.27-0.31 ms against 0.15 ms of
        # device time). No [bh, m, m] scratch, no float atomics, so a second
        # run must give the same bits
        res = landmark._launch_fwd(q, k, m, pad)
        bwd1 = lambda res=res, n=n, pad=pad, g=(gql, gkl, ga2): landmark._launch_bwd(
            res[0], res[1], res[3], n, pad, *g)
        cases.append(Case(
            "landmark_softmax_bwd", "landmark_bwd.cu", "mirror_tpu/ops/landmark_pallas.py:148",
            shape, bwd1,
            lambda q=q, k=k, m=m, pad=pad, g=(gql, gkl, ga2): landmark.landmark_softmax_bwd_ref(
                q, k, m, pad, *g),
            BOUND_BWD, ("dq", "dk"),
            dict(bytes=nbytes(q_l, k_l, gql, gkl, ga2, dq, dq) + 4 * bh * m,
                 mma=3 * 2 * bh * m * m * dh,
                 alt_bytes=("the TPU kernel's residuals (q, k)",
                            nbytes(q, k, gql, gkl, ga2, dq, dq))),
            check=same_bits_check(torch, "landmark_softmax_bwd", bwd1)))

        g3 = randn(b, HEADS, m, dh)
        # the same SDPA on zero-padded k and w (built outside the timed
        # call), its backward through autograd: kernel 3c's function
        k_pad = torch.cat([k.new_zeros(b, HEADS, pad, dh), k], dim=2)
        v_pad = torch.cat([v.new_zeros(b, HEADS, pad, dh), v], dim=2)
        bwd3 = autograd_kernel(torch, lambda a, b, c, pad=pad:
                               nystrom_attn.softmax_matmul_landmark_kv(a, b, c, pad),
                               (q_l, k, v), (g3,))
        cases.append(Case(
            "softmax_attn_bwd", "softmax_attn_bwd.cu", "mirror_tpu/ops/nystrom_pallas.py:152",
            f"kv: r {m}, c {n}, pad {pad}, b {b}, dh {dh}", bwd3,
            lambda q_l=q_l, k=k, v=v, g3=g3, pad=pad: nystrom_attn.softmax_attn_bwd_ref(
                q_l, k, v, g3, pad),
            BOUND_BWD, ("dq_l", "dk", "dv"),
            dict(bytes=2 * nbytes(q_l, k, v) + nbytes(g3), mma=5 * 2 * bh * m * n * dh,
                 products=(7, 5)),
            check=same_bits_check(torch, "softmax_attn_bwd", bwd3),
            library=autograd_kernel(
                torch, lambda a, b, c: F.scaled_dot_product_attention(a, b, c, scale=1.0),
                (q_l, k_pad, v_pad), (g3,))))

        w = randn(b, HEADS, m, dh)
        kern = randn(HEADS, CONV_TAPS, scale=CONV_TAPS ** -0.5)
        g4 = randn(b, HEADS, n, dh)
        # the conv's backward is conv1d.cu's (kernel 9b), launched by the
        # attention backward's C entry
        bwd4 = autograd_kernel(torch, nystrom_attn.fused_softmax_attn_conv,
                               (q, k_l, w, v, kern), (g4,))
        cases.append(Case(
            "softmax_attn_conv_bwd", ("softmax_attn_bwd.cu", "conv1d.cu"),
            "mirror_tpu/ops/nystrom_pallas.py:318", shape, bwd4,
            lambda q=q, k_l=k_l, w=w, v=v, kern=kern, g4=g4: (
                *nystrom_attn.softmax_attn_bwd_ref(q, k_l, w, g4),
                *nystrom_attn.depthwise_conv_seq_bwd_ref(v, kern, g4)),
            BOUND_BWD, ("dq", "dk_l", "dw", "dv", "dkern"),
            dict(bytes=2 * nbytes(q, k_l, w, v, kern) + nbytes(g4),
                 mma=5 * 2 * bh * n * m * dh, fp32=2 * 2 * bh * n * dh * CONV_TAPS,
                 products=(7, 5)),
            check=same_bits_check(torch, "softmax_attn_conv_bwd", bwd4)))

    # kernel 2b on a softmax-like x (softmax of unit-normal logits, the CUDA
    # tests' pinv input) at the slices' b, h and m, and the self-test's
    for b, m in ((B, M), (SELFTEST_B, SELFTEST_M)):
        bh = b * HEADS
        x = torch.softmax(randn(b, HEADS, m, m).float(), -1).to(torch.bfloat16)
        s = pinv.global_scale(x)
        g2 = randn(b, HEADS, m, m)

        def pinv_bwd_check(out, ref, x=x, s=s, g2=g2, m=m):
            x32 = x.float().requires_grad_()
            pinv.pinv_iterations_ref(x32, s, PINV_ITERS).backward(g2.float())
            u, w = out[0].float().ravel(), x32.grad.ravel()
            cos = (u @ w / (u.norm() * w.norm())).item()
            say(f"[kernel] {PINV_BWD} (m {m}): gx cosine {cos:.6f} against the fp32 autograd "
                f"of the plain iterations (bound {BOUND_PINV_BWD_COS})")
            return cos >= BOUND_PINV_BWD_COS

        cases.append(Case(
            PINV_BWD, "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:171", f"b {b}, h {HEADS}, m {m}",
            lambda x=x, s=s, g2=g2: pinv._pinv_exact_bwd_kernel(x, s, g2, PINV_ITERS),
            lambda x=x, s=s, g2=g2: pinv.pinv_exact_bwd_ref(x, s, g2, PINV_ITERS),
            BOUND_PINV_BWD, ("gx", "gs"),
            # the replay (its last z product skipped) and the sweep: 4 + 8 a step
            dict(bytes=3 * nbytes(x) + nbytes(s), mma=(12 * PINV_ITERS - 1) * 2 * bh * m ** 3,
                 design_bytes=pinv_design_units(PINV_ITERS, 4) * nbytes(x)),
            # held by function, and a second run bit for bit (one block a
            # tile, no split-K or atomics: gx's fp32 sum included)
            check=lambda out, ref, c=pinv_bwd_check, again=same_bits_check(
                torch, PINV_BWD, lambda x=x, s=s, g2=g2: pinv._pinv_exact_bwd_kernel(
                    x, s, g2, PINV_ITERS)): c(out, ref) and again(out, ref),
            library=lambda x=x, s=s, g2=g2: pinv_bwd_library(torch, x, s, g2, PINV_ITERS)))
        if b != B:
            continue
        # the probe exp_pinv_stash's variants: z (and x z) kept, the rest
        # recomputed by the replay's own launches (3 or 2 more products a step)
        for stash, extra in ((1, 3), (2, 2)):
            cases.append(Case(
                f"{PINV_BWD}_stash{stash}", "pinv.cu", "scripts/exp_pinv_stash.py:99",
                f"b {b}, h {HEADS}, m {m}, stash {stash}",
                lambda x=x, s=s, g2=g2, st=stash: pinv._pinv_exact_bwd_kernel(
                    x, s, g2, PINV_ITERS, st),
                lambda x=x, s=s, g2=g2, st=stash: pinv.pinv_exact_bwd_stash_ref(
                    x, s, g2, PINV_ITERS, st),
                BOUND_PINV_BWD, ("gx", "gs"),
                dict(bytes=3 * nbytes(x) + nbytes(s),
                     mma=((12 + extra) * PINV_ITERS - 1) * 2 * bh * m ** 3,
                     design_bytes=pinv_design_units(PINV_ITERS, stash) * nbytes(x)),
                check=pinv_bwd_check,
                library=lambda x=x, s=s, g2=g2: pinv_bwd_library(torch, x, s, g2, PINV_ITERS)))

    for b, c in PPEG_SHAPES:
        img = randn(b, SIDE, SIDE, c)
        kern, bias = randn(7, 7, c, scale=0.1), randn(c, scale=0.1)
        g5 = randn(b, SIDE, SIDE, c)
        conv_w = kern.permute(2, 0, 1).unsqueeze(1).clone()
        conv_w[:, 0, 3, 3] += 1
        img_nchw, g5_nchw = img.permute(0, 3, 1, 2), g5.permute(0, 3, 1, 2)
        bwd5 = autograd_kernel(torch, ppeg.ppeg_fused, (img, kern, bias), (g5,))
        cases.append(Case(
            "ppeg_bwd", "ppeg.cu", "mirror_tpu/ops/ppeg_pallas.py:137",
            f"[{b}, {SIDE}, {SIDE}, {c}]", bwd5,
            lambda img=img, kern=kern, g5=g5: ppeg.ppeg_bwd_ref(img, kern, g5), BOUND_BWD,
            ("dimg", "dk", "db"),
            dict(bytes=3 * nbytes(img) + 2 * nbytes(kern) + nbytes(bias), mma=0,
                 fp32=(2 * 49 * 2 + 2) * img.numel()),
            check=same_bits_check(torch, "ppeg_bwd", bwd5),
            # dinput, dweight and dbias of the depthwise conv with the identity
            # folded into its centre tap: one PyTorch call
            library=lambda g5_nchw=g5_nchw, img_nchw=img_nchw, conv_w=conv_w, c=c:
                torch.ops.aten.convolution_backward(
                    g5_nchw, img_nchw, conv_w, [c], [1, 1], [3, 3], [1, 1], False, [0, 0],
                    c, [True, True, True])))
    return cases + conv_cases(torch, randn, True) + [ln_qkv_case(torch, randn, True)] \
        + probe_cases(torch, randn, True)


def phase_kernels(torch, backward: bool):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + int(backward))

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    cases = backward_cases(torch, randn) if backward else forward_cases(torch, randn)
    results = []
    for case in cases:
        results.append(run_case(torch, case))
    del cases
    torch.cuda.empty_cache()
    # one line per kernel in the JSON: the encoder's shape (the first) gives
    # the times; the errors are the worst over the shapes checked; every
    # other shape's (or form's) times are kept under "by_shape"
    keep = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "rel_fro_err", "library_ratio")
    merged = {}
    for r in results:
        if r["name"] not in merged:
            merged[r["name"]] = dict(r, checked=[r["shape"]], by_shape=[])
            continue
        first = merged[r["name"]]
        first["checked"].append(r["shape"])
        first["by_shape"].append({k: r[k] for k in keep})
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


def step_card_vs_cpu(torch, tag, make_step, batch, n_leaves):
    """One train step at batch 2: the card's kernels against the CPU's plain
    path, same weights and draws, dropout 0. ``make_step(device, generator)``
    builds the model (its weights drawn from ``generator`` when one is
    given) and returns (model, step); ``step(batch)`` runs on ``batch`` moved
    to the device. Holds the loss and the gradients that only the backward
    kernels feed (res_conv, to_qkv, the PPEG convs: ``n_leaves`` of them)."""
    import numpy as np

    t0 = time.perf_counter()
    state = None
    results = {}
    for device in ("cuda", "cpu"):
        model, step = make_step(device, None if state else torch.Generator().manual_seed(SEED))
        if state is None:
            state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        metrics = step({k: v.to(device) for k, v in batch.items()})
        grads = {name: p.grad.detach().float().cpu() for name, p in model.named_parameters()
                 if p.grad is not None and ("res_conv.weight" in name or "to_qkv.weight" in name
                                            or "pos_layer.proj" in name)}
        results[device] = (float(metrics["loss"]), grads)
        del model, step
    loss_gpu, g_gpu = results["cuda"]
    loss_cpu, g_cpu = results["cpu"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    say(f"[{tag}] one step at batch 2, card kernels vs CPU plain path (bf16): loss "
        f"{loss_gpu:.6g} vs {loss_cpu:.6g}, relative error {rel:.4g} (bound "
        f"{BOUND_STEP_LOSS:g}); {time.perf_counter() - t0:.1f} s")
    if not np.isfinite(loss_gpu) or rel > BOUND_STEP_LOSS:
        fail(f"[{tag}] the card's train-step loss disagrees with the CPU reference")
    if set(g_gpu) != set(g_cpu) or len(g_gpu) != n_leaves:
        fail(f"[{tag}] kernel-fed gradient leaves differ: {sorted(g_gpu)} vs {sorted(g_cpu)}")
    worst = []
    for name in sorted(g_cpu):
        a, b = g_gpu[name].ravel(), g_cpu[name].ravel()
        cos = (a @ b / (a.norm() * b.norm())).item()
        ratio = (a.norm() / b.norm()).item()
        say(f"[{tag}]   grad {name}: cosine {cos:.6f}, norm ratio {ratio:.5f}")
        worst.append(cos)
        if not (cos >= BOUND_GRAD_COS and abs(ratio - 1.0) <= BOUND_GRAD_NORM):
            fail(f"[{tag}] gradient of {name} on the card disagrees with the CPU reference")
    return min(worst), rel


def train_step_card_vs_cpu(torch, model_kwargs, args, wsi, rna):
    """The MIRROR train step at batch 2, card against CPU, with the same
    masking noise and VAE eps."""
    import numpy as np

    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_mirror_train_step
    from mirror_tpu_torch.train_mirror import loss_weights_from_args

    kw = dict(model_kwargs, wsi_dropout=0.0, rna_proj_drop_rate=0.0)
    rng = np.random.default_rng(SEED)
    noise = dict(wsi_noise=rng.random((2, N_TOKENS), dtype=np.float32),
                 rna_noise=rng.random((2, EMBED), dtype=np.float32),
                 wsi_eps=rng.standard_normal((2, 128), dtype=np.float32),
                 rna_eps=rng.standard_normal((2, 128), dtype=np.float32))
    batch = dict(wsi=torch.from_numpy(wsi[:2]), rna=torch.from_numpy(rna[:2]))

    def make_step(device, generator):
        model = create_model("mirror", device=device, generator=generator, **kw)
        step = make_mirror_train_step(model, make_optimizer(args, model, 2e-5),
                                      loss_weights_from_args(args), args.wsi_mask_ratio,
                                      args.rna_mask_ratio)
        dev_noise = {k: torch.from_numpy(v).to(device) for k, v in noise.items()}
        return model, lambda b: step(b, noise=dev_noise)

    return step_card_vs_cpu(torch, "train", make_step, batch, 3 * 2 + 6)


def time_steps(torch, step, batch, reps=10, warm=2):
    """``step(batch)`` timed by CUDA events around each of ``reps`` calls
    after ``warm`` warm ones. Returns (median ms, min, max, peak device GiB
    over all the calls, the last call's output)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warm):
        step(batch)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    return statistics.median(times), min(times), max(times), peak, out


def run_entry_point(torch, tag, main_fn, argv, steps_expected):
    """Run a training entry point with every launch count set to 0 just
    before and read just after; hold its train log lines (count, finite)."""
    from mirror_tpu_torch.ops import _common

    lines = _Lines()
    logging.getLogger("train").addHandler(lines)
    torch.cuda.synchronize()
    _common.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        results = main_fn(argv)
        torch.cuda.synchronize()
    finally:
        logging.getLogger("train").removeHandler(lines)
    seconds = time.perf_counter() - t0
    launches = _common.launch_counts()
    steps = [ln for ln in lines.lines if ln.startswith("Train:")]
    say(f"[{tag}] {main_fn.__module__}.main: {len(steps)} steps at batch {B} in {seconds:.2f} s "
        f"(model build, data reads, eval and checkpoint saves included); kernel launches "
        f"{json.dumps(launches)}")
    if len(steps) != steps_expected:
        fail(f"[{tag}] {len(steps)} train log lines, expected {steps_expected}")
    if any(bad in ln.lower() for ln in steps for bad in ("nan", "inf")):
        fail(f"[{tag}] a logged loss is not finite: {steps}")
    for ln in lines.lines:
        if ln.startswith("Eval:"):
            say(f"[{tag}] {ln}")
    say(f"[{tag}] every logged loss finite; last line: {steps[-1]}")
    return results, launches


def phase_train(torch, root: Path):
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch import train_mirror
    from mirror_tpu_torch.config import parse_args, resolve_lr
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_mirror_train_step

    t0 = time.perf_counter()
    root.mkdir(parents=True)
    feat_dir, rna_csv, split_dir = write_pretrain_cohort(root)
    argv = ["--config", str(PRETRAIN_YAML), "--wsi-feature-dir", str(feat_dir),
            "--rna-feature-csv", str(rna_csv), "--split-dir", str(split_dir), "--fold-nb", "0",
            "--output", str(root / "runs"), "--experiment", "smoke", "--epochs", "1",
            "--no-val", "--batch-size", str(B), "--log-interval", "1", "--seed", str(SEED),
            "--workers", "8"]
    say(f"[train] {N_PRETRAIN_SLIDES} slides written, set-up {time.perf_counter() - t0:.1f} s")

    results, launches = run_entry_point(torch, "train", train_mirror.main, argv, TRAIN_STEPS)
    run_dir = root / "runs" / "pretrain" / "smoke"
    summary = pd.read_csv(run_dir / "summary.csv")
    names = ["loss", "alignment_loss", "wsi_retention_loss", "rna_retention_loss",
             "style_loss", "cluster_loss"]
    if not np.isfinite(summary[[f"train_{n}" for n in names]].to_numpy()).all():
        fail("a loss in summary.csv is not finite")
    if results.get("metric_name") != "loss" or not np.isfinite(results["best_metric"]):
        fail(f"--result is not what a finished run prints: {results}")
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
    step_ms, lo, hi, peak_gib, metrics = time_steps(torch, train_step, batch)
    say(f"[train] train step at batch {B}, full width, bf16: median {step_ms:.3f} ms over 10 "
        f"(min {lo:.3f}, max {hi:.3f}), {1000 * B / step_ms:.1f} samples/s; "
        f"peak device memory {peak_gib:.2f} GiB; loss {float(metrics['loss']):.6g}")
    profile_step(torch, train_step, batch, step_ms)
    del model, train_step
    torch.cuda.empty_cache()

    cos, rel = train_step_card_vs_cpu(torch, model_kwargs, args, host["wsi"], host["rna"])

    # --pinv-grad exact (kernel 2b): 2 steps through train_mirror.main on 32
    # of the slides, then the step timed on the resident batch
    exact_split = root / "splits_exact"
    exact_split.mkdir()
    train_ids = pd.read_csv(split_dir / "splits_0.csv", index_col=0)["train"].tolist()
    pd.DataFrame({"train": train_ids[:TRAIN_STEPS_EXACT * B],
                  "val": [None] * (TRAIN_STEPS_EXACT * B)}).to_csv(exact_split / "splits_0.csv")
    argv_exact = [*argv, "--split-dir", str(exact_split), "--experiment", "smoke_exact",
                  "--pinv-grad", "exact"]
    _, launches_exact = run_entry_point(torch, "train exact", train_mirror.main, argv_exact,
                                        TRAIN_STEPS_EXACT)
    # one 2b launch per Nystrom layer (3) and step
    if launches_exact.get(PINV_BWD, 0) != 3 * TRAIN_STEPS_EXACT:
        fail(f"train_mirror --pinv-grad exact launched {PINV_BWD} "
             f"{launches_exact.get(PINV_BWD, 0)} times, expected {3 * TRAIN_STEPS_EXACT}")
    model = create_model("mirror", device="cuda", generator=torch.Generator().manual_seed(SEED),
                         **dict(model_kwargs, pinv_grad="exact"))
    train_step = make_mirror_train_step(
        model, make_optimizer(args, model, resolve_lr(args, B)),
        train_mirror.loss_weights_from_args(args), args.wsi_mask_ratio, args.rna_mask_ratio,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    exact_ms, lo, hi, exact_gib, metrics = time_steps(torch, train_step, batch, reps=5)
    say(f"[train exact] train step at batch {B}, --pinv-grad exact: median {exact_ms:.3f} ms "
        f"over 5 (min {lo:.3f}, max {hi:.3f}), {1000 * B / exact_ms:.1f} samples/s; peak "
        f"device memory {exact_gib:.2f} GiB; loss {float(metrics['loss']):.6g}")
    profile_step(torch, train_step, batch, exact_ms, tag="train exact")
    del model, train_step, batch
    torch.cuda.empty_cache()
    return launches, launches_exact, dict(step_ms=step_ms, peak_gib=peak_gib,
                                          worst_grad_cos=cos, step_loss_rel=rel,
                                          exact_step_ms=exact_ms, exact_peak_gib=exact_gib)


def write_downstream_cohort(root: Path):
    """48 slides (fp16 Phikon-width patches, a 10234-gene RNA CSV) in the
    subtyping class layout ({root}/classes/{class}/, links to the flat
    {root}/features/ that survival reads), a fold-0 split of 32 train and
    16 val patients, and a survival CSV in the cBioPortal columns (about a
    quarter censored), all from SEED."""
    import numpy as np
    import pandas as pd

    feat_dir, rna_csv, ids = write_cohort(root, N_DOWN_SLIDES, "DS")
    classes = root / "classes"
    for i, sid in enumerate(ids):
        cls_dir = classes / CLASSES[i % 2]
        cls_dir.mkdir(parents=True, exist_ok=True)
        (cls_dir / f"{sid}.npy").symlink_to(feat_dir / f"{sid}.npy")
    split_dir = root / "splits"
    split_dir.mkdir()
    patients = [s[:12] for s in ids]
    pd.DataFrame({"train": pd.Series(patients[:N_DOWN_TRAIN]),
                  "val": pd.Series(patients[N_DOWN_TRAIN:])}).to_csv(split_dir / "splits_0.csv")
    rng = np.random.default_rng(SEED + 7)
    surv_csv = root / "survival.csv"
    pd.DataFrame({
        "Patient ID": patients, "Sample ID": [s[:15] for s in ids],
        "Overall Survival (Months)": np.round(rng.uniform(1, 120, len(ids)), 2),
        "Overall Survival Status": np.where(rng.random(len(ids)) < 0.25, "0:LIVING",
                                            "1:DECEASED"),
    }).to_csv(surv_csv, index=False)
    return feat_dir, classes, rna_csv, split_dir, surv_csv


def downstream_step(torch, task, argv):
    """The entry point's own model, loader and train step, built as its
    ``main`` builds them, and the first host batch of its loader."""
    from mirror_tpu_torch.config import parse_args
    from mirror_tpu_torch.data.datasets import SubtypingDataset, SurvivalDataset
    from mirror_tpu_torch.train.steps import make_classifier_train_step, make_survival_train_step
    from mirror_tpu_torch.train_subtyping import (
        build_classifier,
        setup,
        train_loader_and_optimizer,
    )

    args, _ = parse_args(argv, task=task)
    device = setup(args)
    if task == "subtyping":
        dataset = SubtypingDataset(args.wsi_feature_dir, args.rna_feature_csv, args.classes,
                                   args.num_wsi_feature_tokens, splits=args.split_dir)
        model = build_classifier(args, dataset, len(args.classes), device)
    else:
        dataset = SurvivalDataset(args.wsi_feature_dir, args.rna_feature_csv,
                                  args.survival_csv, args.num_wsi_feature_tokens,
                                  splits=args.split_dir, num_bins=args.num_bins)
        model = build_classifier(args, dataset, args.num_bins, device)
    loader, optimizer, _ = train_loader_and_optimizer(args, dataset, model)
    gen = torch.Generator(device=device).manual_seed(SEED)
    if task == "subtyping":
        step = make_classifier_train_step(model, optimizer, smoothing=args.smoothing,
                                          generator=gen)
    else:
        step = make_survival_train_step(model, optimizer, loss_name=args.loss,
                                        loss_alpha=args.loss_alpha, generator=gen)
    return args, model, step, next(iter(loader))


def phase_downstream(torch, root: Path, pretrain_ckpt: Path):
    """Subtyping (linear probe, warm-started from phase 5's checkpoint) and
    survival (fine-tuning, --pinv-grad exact) through their entry points at
    the templates' full width; their steps timed; a batch-2 exact classifier
    step held against the CPU; predict scoring the subtyping checkpoint."""
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch import train_subtyping, train_survival
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.tools.predict import predict
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_classifier_train_step

    t0 = time.perf_counter()
    root.mkdir(parents=True)
    feat_dir, classes, rna_csv, split_dir, surv_csv = write_downstream_cohort(root)
    say(f"[downstream] {N_DOWN_SLIDES} slides written ({N_DOWN_TRAIN} train), set-up "
        f"{time.perf_counter() - t0:.1f} s")
    common = ["--rna-feature-csv", str(rna_csv), "--split-dir", str(split_dir), "--fold-nb",
              "0", "--output", str(root / "runs"), "--epochs", str(DOWN_EPOCHS), "--batch-size",
              str(B), "--log-interval", "1", "--seed", str(SEED), "--workers", "8"]
    argv_sub = ["--config", str(SUBTYPING_YAML), "--wsi-feature-dir", str(classes),
                "--classes", *CLASSES, "--initial-checkpoint", str(pretrain_ckpt),
                "--experiment", "subtyping", *common]
    survival_yaml = root / "survival.yaml"
    survival_yaml.write_text(SURVIVAL_YAML.read_text().replace("linear_probe: true",
                                                               "linear_probe: false"))
    argv_surv = ["--config", str(survival_yaml), "--wsi-feature-dir", str(feat_dir),
                 "--survival-csv", str(surv_csv), "--pinv-grad", "exact",
                 "--experiment", "survival", *common]
    steps = DOWN_EPOCHS * (N_DOWN_TRAIN // B)
    launches = {}
    for task, main_fn, argv, metric_ranges in (
            ("subtyping", train_subtyping.main, argv_sub,
             {"acc": (0, 100), "auc": (0, 1), "f1": (0, 1)}),
            ("survival", train_survival.main, argv_surv, {"c-index": (0, 1)})):
        results, launches[task] = run_entry_point(torch, task, main_fn, argv, steps)
        summary = pd.read_csv(root / "runs" / task / task / "summary.csv")
        for name, (lo, hi) in metric_ranges.items():
            vals = summary[f"eval_{name}"].to_numpy()
            if not (np.isfinite(vals).all() and (vals >= lo).all() and (vals <= hi).all()):
                fail(f"[{task}] eval {name} {vals} not finite in [{lo}, {hi}]")
        if not np.isfinite(summary[["train_loss", "eval_loss"]].to_numpy()).all():
            fail(f"[{task}] a loss in summary.csv is not finite")
        say(f"[{task}] --result {json.dumps(results)}")
        wanted = FORWARD + BACKWARD + ((PINV_BWD,) if task == "survival" else ())
        missing = [k for k in wanted if launches[task].get(k, 0) == 0]
        if missing:
            fail(f"[{task}] never launched: {missing}")

        args, model, step, host = downstream_step(torch, task, argv)
        batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        ms, lo, hi, peak, metrics = time_steps(torch, step, batch, reps=5)
        mode = "linear probe" if args.linear_probe else "fine-tuning"
        say(f"[{task}] train step at batch {B} ({mode}, --pinv-grad {args.pinv_grad}): "
            f"median {ms:.3f} ms over 5 (min "
            f"{lo:.3f}, max {hi:.3f}), {1000 * B / ms:.1f} samples/s; peak device memory "
            f"{peak:.2f} GiB; loss {float(metrics['loss']):.6g}")
        profile_step(torch, step, batch, ms, tag=task)
        del model, step, batch
        torch.cuda.empty_cache()

    # one classifier step at batch 2 with the exact pinv gradient, card
    # against CPU (the subtyping run's arguments and widths)
    args, model, _, host = downstream_step(torch, "subtyping", argv_sub)
    kw = dict(args.model_kwargs, pinv_grad="exact", wsi_dropout=0.0, rna_proj_drop_rate=0.0)
    del model
    batch = {k: torch.from_numpy(host[k][:2]) for k in ("wsi", "rna", "label")}

    def make_step(device, generator):
        model = create_model("mirror_classifier", device=device, generator=generator, **kw)
        return model, make_classifier_train_step(model, make_optimizer(args, model, args.lr),
                                                 smoothing=args.smoothing)

    step_card_vs_cpu(torch, "downstream", make_step, batch, 2 * 2 + 6)

    # predict scores with the subtyping checkpoint
    ckpt = root / "runs" / "subtyping" / "subtyping" / "last.pth.tar"
    out_csv = root / "predictions.csv"
    predict(str(ckpt), "subtyping", str(classes), str(out_csv), rna_feature_csv=str(rna_csv),
            batch_size=B, seed=SEED, device="cuda")
    df = pd.read_csv(out_csv)
    probs = df[["prob_0", "prob_1"]].to_numpy()
    if len(df) != N_DOWN_SLIDES or not np.isfinite(probs).all() \
            or np.abs(probs.sum(1) - 1.0).max() > 1e-5:
        fail(f"predict on the subtyping checkpoint: {len(df)} rows or bad probabilities")
    say(f"[downstream] predict scored the subtyping checkpoint: {len(df)} rows, "
        f"probabilities finite, rows sum to 1")
    return launches


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
    """Median ms of the backbone on one resident uint8 batch."""
    ms, lo, hi, _, _ = time_steps(torch, fn, images)
    say(f"[featgen] {label} backbone, batch {images.shape[0]} resident uint8: median {ms:.3f} ms "
        f"over 10 (min {lo:.3f}, max {hi:.3f}), {1000 * images.shape[0] / ms:.1f} patches/s")
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

    # per Phikon batch: each block's two half-blocks, each of them an LN pass
    # and two GEMM launches
    runs = {"phikon": ([], 768, {"vit_attn_block": VIT_DEPTH, "vit_mlp_block": VIT_DEPTH,
                                 "vit_ln": 2 * VIT_DEPTH, "vit_gemm": 4 * VIT_DEPTH}),
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


def phase_selftest(torch):
    """The self-test's entry point at bench.py's shapes, its launches read
    around it; then its NystromAttention at batch 2, card against CPU."""
    from mirror_tpu_torch import selftest
    from mirror_tpu_torch.ops import _common

    torch.cuda.synchronize()
    _common.reset_launch_counts()
    t0 = time.perf_counter()
    rc = selftest.main([])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _common.launch_counts()
    say(f"[selftest] mirror_tpu_torch.selftest.main(): exit {rc} in {seconds:.2f} s (host "
        f"clock, weight draws included); kernel launches {json.dumps(launches)}")
    if rc != 0:
        fail("the self-test reported a mode that is not finite")
    # one forward and one backward of each Nystrom kernel per gradient mode,
    # the exact pinv backward once, PPEG and the conv once each
    want = {k: 1 if k in ("ppeg", "ppeg_bwd", "conv1d", "conv1d_bwd") else 2
            for k in SELFTEST_PATH}
    want[PINV_BWD] = 1
    # the pinv's GEMM: 24 launches a forward (one a gradient mode), 71 a
    # backward (the exact mode)
    want[PINV_GEMM] = 2 * 4 * PINV_ITERS + 12 * PINV_ITERS - 1
    if launches != want:
        fail(f"the self-test's kernel launches {launches}, expected {want}")

    rng = torch.Generator().manual_seed(SEED)
    batch = {"x": torch.randn(2, N, SELFTEST_DIM, generator=rng)}
    for mode in ("exact", "implicit"):
        def make_step(device, generator, mode=mode):
            model = selftest.attention(SELFTEST_DIM, mode).to(device)

            def step(b):
                loss = model(b["x"]).float().square().mean()
                loss.backward()
                return {"loss": loss.detach()}
            return model, step

        step_card_vs_cpu(torch, f"selftest {mode}", make_step, batch, 2)
    return launches


# the probes of mirror_tpu_torch/scripts at their scripts' default shapes,
# their reps cut to keep phase 9 short (never their shapes)
PROBES = (
    ("exp_hbm_floor", ["--steps", "10", "--reps", "3"]),
    ("exp_conv_parts", ["--steps", "10", "--reps", "3"]),
    ("exp_ln_qkv", ["--chain", "4", "--reps", "3"]),
    ("exp_pinv_stash", ["--chain", "2", "--reps", "3"]),
    ("exp_vit_attn_kernel", ["--steps", "8", "--reps", "3"]),
    ("exp_vit_fused_sublayer", ["--steps", "4", "--reps", "3"]),
)


def phase_probes(torch):
    """Each probe's ``main`` at its script's shapes, its rows and JSON line
    printed, its own checks held again here; the launches read around the
    six."""
    import contextlib
    import importlib
    import io

    from mirror_tpu_torch.ops import _common

    torch.cuda.synchronize()
    _common.reset_launch_counts()
    t0 = time.perf_counter()
    lines = {}
    for name, argv in PROBES:
        module = importlib.import_module(f"mirror_tpu_torch.scripts.{name}")
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = module.main(argv)
        torch.cuda.synchronize()
        text = out.getvalue()
        sys.stdout.write(text)
        say(f"[probe] {name} {' '.join(argv)}: exit {rc} in {time.perf_counter() - t1:.1f} s")
        if rc != 0:
            fail(f"probe {name} exited {rc}")
        lines[name] = {r["name"]: r for r in json.loads(text.strip().splitlines()[-1])["variants"]}
    launches = _common.launch_counts()
    say(f"[probes] {time.perf_counter() - t0:.1f} s; kernel launches {json.dumps(launches)}")

    copies = [r for r in lines["exp_hbm_floor"].values() if r["kind"] == "kernel"]
    if not all(r["bit_exact"] for r in copies):
        fail("a copy_floor launch shape is not bit for bit its input")
    # kernels 9, 9b and 10, 10b at the probes' shapes (b 64), and 2b below
    conv = lines["exp_conv_parts"]
    if conv["bwd dv only"]["err"] != 0.0:
        fail("the conv backward's dv alone is not the fused kernel's dv bit for bit")
    fused = conv["bwd fused dv+dk"]
    held = [("conv1d fwd", conv["fwd"]["err"], BOUND_SINGLE_ROUNDING),
            ("conv1d_bwd dv+dkern", fused["err"], BOUND_BWD),
            ("conv1d_bwd dkern sum", fused["dkern_sum_err"], fused["dkern_sum_bar"]),
            ("ln_qkv", lines["exp_ln_qkv"]["fwd fused|bigg"]["err"], BOUND_SINGLE_ROUNDING)]
    both = lines["exp_ln_qkv"]["fwd+bwd fused|bigg"]
    held.append(("ln_qkv_bwd", both["err"], BOUND_BWD))
    held += [(f"ln_qkv_bwd {g} sum", e, both["sum_bar"][g]) for g, e in both["sum_err"].items()]
    for what, err, bar in held:
        if not err <= bar:
            fail(f"{what} at the probes' shape: err {err} > {bar} against its plain version")
    for name, r in lines["exp_vit_attn_kernel"].items():
        if name.startswith("k") and not r["err"] <= BOUND_SINGLE_ROUNDING:
            fail(f"vit_attn.cu {name}: rel Frobenius err {r['err']} > {BOUND_SINGLE_ROUNDING}")
    for name, r in lines["exp_vit_fused_sublayer"].items():
        errs = (r["err"], r.get("err_added", 0.0))
        if name.startswith("k") and not max(errs) <= BOUND_SINGLE_ROUNDING:
            fail(f"vit_fused.cu {name}: rel Frobenius err (out, out - x) {errs} > "
                 f"{BOUND_SINGLE_ROUNDING}")
    full = lines["exp_pinv_stash"]["full"]["vs_plain"]
    if not (full["err_gx"] <= BOUND_PINV_BWD and full["err_gs"] <= BOUND_PINV_BWD
            and full["cosine_gx"] >= BOUND_PINV_BWD_COS):
        fail(f"moore_penrose_pinv_bwd (2b) at b 64 disagrees with its plain version: {full}")
    for name in ("z+xz", "z"):
        r = lines["exp_pinv_stash"][name]
        if not (r["err_gx"] <= BOUND_PINV_BWD and r["err_gs"] <= BOUND_PINV_BWD
                and r["grad_cosine_small"] >= BOUND_PINV_BWD_COS):
            fail(f"pinv stash variant {name} disagrees with the full stash: {r}")
    return launches


def main() -> int:
    import torch

    phase_device(torch)
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
        train, train_exact, _ = phase_train(torch, Path(tmp) / "train")
        with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp_fg:
            featgen = phase_featgen(torch, Path(tmp_fg))
        pretrain_ckpt = Path(tmp) / "train" / "runs" / "pretrain" / "smoke" / "last.pth.tar"
        down = phase_downstream(torch, Path(tmp) / "downstream", pretrain_ckpt)
    selftest_launches = phase_selftest(torch)
    probe_launches = phase_probes(torch)
    # the main paths' launches: predict's, the train step's (implicit and
    # exact pinv gradient), feature extraction's (its three runs), the two
    # downstream entry points' and the self-test's, each counted from 0 just
    # before its run. Exempt: softmax_attn_q, the pad-0 entry of the
    # softmax_attn kernel, which no path calls (its callers all have the
    # residual conv). ln_qkv and ln_qkv_bwd, library-only as in the JAX
    # package, run on the probes' path (exp_ln_qkv), as do the kernels the
    # probes added
    paths = {"predict": serve, "train": train, "train_exact": train_exact,
             "featgen": featgen, "subtyping": down["subtyping"],
             "survival": down["survival"], "selftest": selftest_launches,
             "probes": probe_launches}
    for k in kernels:
        k["launches_by_path"] = {path: counts.get(k["name"], 0) for path, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    exempt = ("softmax_attn_q",)
    unlaunched = [k["name"] for k in kernels if k["launches"] == 0 and k["name"] not in exempt]
    if unlaunched:
        fail(f"kernels no main path launched: {unlaunched}")
    say(f"[done] {time.perf_counter() - t_start:.1f} s after the device check")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
