#!/usr/bin/env python3
"""Drive the PyTorch port of MIRROR once on one NVIDIA card, and check it.

    python3 chip_smoke.py            # from the repo root; one CUDA card, nvcc
    python3 chip_smoke.py --ddp-ranks 4   # only the build and phase 5d's group
                                          # check, one NCCL process a card, then
                                          # data 2 x model 2 (phase 5e's check)
    python3 chip_smoke.py --cp-ranks 4    # only the build and phase 10's group
                                          # check, one NCCL process a card

Phases, each printed as it finishes:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of ``mirror_tpu_torch/csrc`` compiled from the
   checkout's sources, with its build time, and what ``-Xptxas -v`` says
   of the redesigned kernels (the landmark softmax, the Nystrom and ViT
   attention, PPEG, the pinv's GEMM, the ViT projection GEMM and its LN
   pass, the copy floor, the fused ViT sub-layers, the fused LN + q/k/v
   projection, the conv along the sequence and the column sum: registers,
   shared memory, spills, ptxas's performance warnings);
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
   (on its launch wrapper: through autograd a call is host-bound) and the
   LN + q/k/v projection at phase 3's shapes; the Nystrom
   backwards, 2b ([8, 8, 256, 256]) and PPEG's at the self-test's shapes
   as in phase 3), error per output
   (the batch sums dkern, gw, gs and gb also against their largest
   magnitude), and the same times; the landmark softmax's backward (1b),
   the attention backwards (3c, 4b), PPEG's (5b), the exact pinv
   backward (2b) and the LN + q/k/v projection's (10b) run twice on the
   same inputs and must give the same bits;
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
5b. the CLIP baseline: ``mirror_tpu_torch.train_pretrain.main`` (the dual
   encoder, InfoNCE) on 48 of phase 5's slides with 16 validating, at full
   width (768-d features, 2048 tokens, RNA 10234, embed 768, batch 16,
   bf16, implicit pinv gradient) with the optimizer side's flags (lamb, a
   cosine schedule on updates with a warmup epoch, AGC at 0.01, the EMA with
   its ramp, gradient accumulation 2), 2 epochs of 3 micro-batches: launch
   counts read around it (two of each Nystrom kernel forward and backward
   and one of PPEG's a micro-step), summary.csv with the lr and the EMA's
   eval loss, the ``.pth.tar`` with ``state_dict_ema`` reloaded; one step
   at batch 2 on the card against the CPU's plain path in fp32; on 4
   (weights, batch) pairs the PPEG biases' gradient (5b's sum against the
   float64 sum of the gradient it was given, that gradient against fp32's,
   the bias gradient of the card and of the CPU's bf16 path against fp32);
   the step timed per real update (ms, peak memory) without the EMA, with
   it, and with it and accumulation 2, and profiled; the update, the EMA's
   update and accumulation's pair of calls timed alone;
5c. the run control (ROADMAP item 10) on 32 of phase 5's slides (2
   steps of 16 an epoch, full width, the EMA on): the loader's C++ gather
   taken on the ``.npy`` cohort and its host ms per batch against the
   numpy path's; ``train_mirror.main`` for 2 epochs straight (the second
   under ``--profile``, whose trace must name kernels of ``csrc/``)
   against 1 epoch and ``--resume last.pth.tar`` for the second, the
   weights, the EMA and the moments compared (bit for bit, or the step's
   bars with the ops that do not repeat named); a SIGTERM sent from within
   the first step, the recovery file and its reload; the cost of a save
   with the optimizer's state; one step without and with
   ``--grad-checkpointing`` on the same batch, weights and generator
   state (the gradients held, kernels 1-4 launched twice as often and 2's
   GEMM 144 times, the backwards and PPEG as often; ms and peak memory of
   both; its launches under ``train_gradckpt``), and one with
   ``--pinv-grad exact`` (2b at 3 a step);
5d. data parallelism (ROADMAP item 14) on 32 of phase 5's slides (2 steps
   of 16): ``train_mirror.main`` as one rank of a NCCL group
   (``MIRROR_COORDINATOR`` with one process: the DDP wrapper over NCCL;
   at world size 1 the scale's all-reduce, the gathers and the agreed stop
   issue no collective, so the cross-rank math runs in the gloo pair
   below and under ``--ddp-ranks``) against the same run without a group,
   the losses and the saved weights bit for bit (the first leaf that differs named; its
   launches under ``train_ddp``), the group's init and the step with and
   without DDP timed; then two processes on the one card over gloo
   (``parallel/worker.py``), a global batch of 16 split 8 / 8 with global
   negatives and the masking noise and eps injected, dropout 0: the ranks'
   averaged gradients against the one-process step on the card from the
   same weights, batch and draws at phase 5's bars, the two ranks' weights
   the same bits after the update, then again with
   ``--optimizer-sharding``; the group's init, the first step and the
   step's median of each;
5e. tensor parallelism (ROADMAP item 16) on 32 of phase 5's slides (2 steps
   of 16), dropout 0: ``train_mirror.main`` in one process on the card, then
   as two gloo processes on the one card at ``--model-parallel 2`` (data 1
   x model 2: the RNA embedding, the block MLPs, both retention heads and
   the prototypes split over the two ranks; the WSI encoder whole on each,
   its kernels launched by each), in ONE spawn of ``parallel/worker.py``
   (``cases``): the losses against the one-process run's (bar
   ``TP_BOUND_EPOCH_LOSS``), the gathered saved weights at the one-process
   run's keys and shapes and each leaf's update (the weights less the
   seeded initial ones) printed, the worst leaf named; the run again with
   ``--optimizer-sharding``, its weights the same bits (at data 1 ZeRO-1
   has one range); the launches of rank 0's run under ``train_tp``; then one
   step with the masking noise and eps injected against the one-process
   step (gradients gathered whole, at phase 5e's own bars
   ``TP_BOUND_*``, the worst leaf named), each rank's bytes of
   parameters, Adam moments and EMA against one process's, the step's
   median; ``--ddp-ranks 4`` adds data 2 x model 2 over NCCL, with and
   without ZeRO-1, to phase 5d's four-card check;
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
   one resident batch (ms, peak memory) and profiled; the survival run
   again with the optimizer side (SGD, the plateau schedule, the EMA,
   clipping at a global norm of 1; its launches under their own path, the
   EMA's eval metrics and weights checked); one classifier step
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
   calls;
10. whole-slide encoding (ROADMAP item 15) at the subtyping template's
   width (768-d features, embed 768, 8 heads of 96, 384 landmarks, bf16,
   weights from a seed): 4 synthetic slides of 2,000, 15,000, 40,000 and
   100,000 patches (fp16 ``.npy``) through
   ``mirror_tpu_torch.tools.encode_slide.main``, every patch, the launches
   of kernels 2, 3, 3b, 9 and 5 read around it (the ``whole_slide`` path);
   each slide's encode timed at world 1 (ms, patches/s, peak memory); the
   world-1 context-parallel encoder on the 40,000 slide against
   ``FeatureTransMIL.encode``'s kernel path and on the 15,000 slide against
   the CPU's plain path in fp32; kernels 3 (as the combine launches it,
   with its row log-sum-exp), 3b, 9 (on the halo-extended block) and 5 at
   the 100,000 slide's shapes against their plain versions at phase 3's
   bars (their rows in the JSON's "by_shape"); ``predict --whole-slide``
   and ``predict`` on two slides; one CP attention layer's output and
   gradient of sum(out t) (the exact pinv gradient) at world 1 against the
   plain path (``use_pallas=False``) on the card at phase 5's bars; then
   two gloo processes on the one card (``parallel/cp_worker.py``): the
   100,000 slide against world 1, the same layer's output and gradient
   (kernels 3c, 9b and 2b through the collectives) against world 1 at
   phase 5's bars, and both predicts in 2 ranks against one process;
11. the tools (ROADMAP item 17), run right after phase 7 on its
   checkpoints: ``tools/export_model.py`` exports phase 7's subtyping
   checkpoint (``classifier``) and phase 5's pretrain checkpoint
   (``embed``) on the card at batch 16 (2048 tokens x 768, RNA 10234;
   the batch 2 seeded slides tiled 8 times), each graph calling the five
   ``mirror::`` ops; a fresh process that imports only
   ``mirror_tpu_torch.ops`` loads each ``.pt2`` and runs it on the card
   (the launches of kernels 1-5 read around one batch: the ``export``
   path; ms a batch), its outputs against the eager module on the card
   (bit for bit, else it fails; the difference printed) and against the
   CPU's plain path on the 2 slides (phase 4's bar); the export time and
   the artifact's bytes; the host cost of an op's dispatch (``ppeg`` and
   ``landmark_softmax`` through the op against a direct call of their CUDA
   implementation, small shapes, in turns); ``split_weights`` on phase 5's
   ``last.pth.tar``; ``import_jax_checkpoint`` in a process of its own on
   a msgpack file that flax wrote, importing none of jax, flax, msgpack
   or ml_dtypes; then
   ``pretrain_job_launcher`` at k 2 on slot 0 (two jobs at once; the
   pretrain template on 16 + 16 of phase 5's slides a fold, one step) and
   ``downstream_tasks_evaluator`` on its run directories (the subtyping
   template on phase 7's slides, warm-started from each fold), run
   without this process's ``MIRROR_PLATFORM``, their exit codes, the
   ``CUDA_VISIBLE_DEVICES`` each job was given and the device each job's
   model was created on (the card, else it fails) printed;
12. the float32 and float16 instances of kernels 1-5 and 9 (the compute
   types of ``--no-amp`` and ``--amp-dtype float16``): (a) right after
   phase 3b, the bf16 instances' outputs at the train slice's shapes held to
   the bits of the tree before those instances were added (BF16_DIGESTS),
   then each float32 and float16 instance, forward and backward, against its
   plain version in its own type at the train slice's shapes (the encoder's
   2117 rows with pad 187; PPEG on [16, 46, 46, 768]; the exact pinv at
   [16, 8, 384, 384]; the conv on [16, 8, 2117, 96]), at their bars, with
   its median time, its bound (float16 products at 989 TFLOP/s, float32's
   at the 3xTF32 rate of 165) and the PyTorch call in that type (TF32 off),
   each a row ``name[float32]`` or ``name[float16]`` of the JSON; (c) after
   phase 4, ``predict`` on checkpoints whose args say ``amp: false`` and
   ``amp_dtype: float16`` (16 slides, launches read around each run, two
   slides against the CPU's float32 plain path) and ``predict
   --whole-slide`` on two whole slides in each type (kernels 2, 3, 3b, 9,
   5), then one CP attention layer's gradient at world 1 in each type
   (3c, 9b and 2b) against its float32 plain path on the card; (b) after
   phase 5, ``train_mirror.main`` at full width with ``--no-amp`` and with
   ``--amp-dtype float16`` (4 steps each on phase 5's cohort; the launches
   of every instance read around each run and no bf16 instance launched;
   the ``--result`` JSON; the ``.pth.tar`` reloaded in its type), each
   type's step timed on one resident batch (ms, peak memory), and one
   batch-2 step against the CPU's float32 plain path (float32: loss 1e-4,
   gradient cosine 0.9999; float16: phase 5's bars);
13. every Nystrom width the JAX package serves, after phase 10: (a) kernels
   1, 3, 3b, 4 and 9 at embed 1536's serving shapes ([16, 8, 2117, 192],
   768 landmarks, pad 187: the 1536-wide tile features of UNI2-h,
   Prov-GigaPath's tile encoder, H-optimus-0) and embed 792's (dh 99, 396
   landmarks, pad 259) against their plain versions in bf16 (timed, with
   SDPA and ``conv2d`` as the library calls; kernels 2 and 5 too, at m and
   C of the width), float32 (3, 3b and 4 timed) and float16 (checked), each
   shape a ``by_shape`` entry of its kernel's row; (b) on checkpoints of the
   subtyping template at each width, ``predict`` (16 slides in bf16: the
   rate and the batch's peak memory; 4 in float32 and float16) and
   ``predict --whole-slide`` (a 3,000-patch slide in each type), launches
   read around each run, two slides against the CPU's float32 plain path at
   phase 4's bar; at embed 1536 ``encode_slide`` on a 15,000-patch slide, the
   exported classifier against its eager module bit for bit, and
   ``train_mirror`` refused at start, naming the backward kernels.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
The script imports nothing of JAX.
"""

import contextlib
import json
import logging
import math
import os
import re
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
        BOUND_BWD, BOUND_F32, BOUND_F32_BWD, BOUND_PINV_BWD, BOUND_PINV_BWD_COS,
        BOUND_SINGLE_ROUNDING, PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_MMA_FLOPS, bound, events_ms,
        nbytes, rel_err, sum_bound, sum_err)
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
# the run control (phase 5c): 2 steps an epoch on 32 of phase 5's slides;
# kernels of csrc/ whose names the --profile trace of a train epoch must hold
RC_STEPS = 2
# data parallelism (phase 5d): 2 steps of 16 on 32 of phase 5's slides; the
# gloo pair's timed steps and its launch's time limit
DDP_STEPS, DDP_REPS, DDP_TIMEOUT_S = 2, 3, 300.0
# tensor parallelism (phase 5e): the model ranks of the gloo pair on the one
# card and of --ddp-ranks 4 (data 2 x model 2)
TP_MODEL_PARALLEL = 2
# Phase 5e's bars. Both sides run the same kernels in bf16 on the one card
# from the same weights and batch; only the split products' sums and the
# collectives change the order of work. Its injected step read a loss 2.93e-5
# relative, a worst leaf gradient cosine 0.999715 and a norm ratio 1.00222
# (NVIDIA H100 80GB HBM3, 700 W, two runs alike): the step is held to 1e-3,
# 0.999 and 1e-2, a few times those readings and far inside phase 5's
# card-vs-CPU bars, so a wiring fault (a bias added on each rank, a slice in
# the wrong place) shows. The 2-step epochs' losses read 2.99e-4 (Adam's
# first update is near sign(g), so bf16 differences in small gradients move
# step 2): held to 2e-3. Each leaf's update after the epoch (0.992303 worst)
# is printed, not gated: it says little near sign(g).
TP_BOUND_STEP_LOSS, TP_BOUND_GRAD_COS, TP_BOUND_GRAD_NORM = 1e-3, 0.999, 1e-2
TP_BOUND_EPOCH_LOSS = 2e-3
RC_TRACE_KERNELS = ("landmark_fwd_kernel", "pinv_gemm_kernel", "softmax_attn_kernel",
                    "attn_bwd_rows_kernel", "ppeg_kernel", "ppeg_bwd_kernel")
# the CLIP baseline (train_pretrain): 48 of phase 5's slides train (3
# micro-batches of 16 an epoch), 16 validate; the optimizer side's flags
CLIP_MICRO_STEPS = 3
CLIP_FLAGS = ["--opt", "lamb", "--use-sched", "--sched", "cosine", "--sched-on-updates",
              "--warmup-epochs", "1", "--clip-grad", "0.01", "--clip-mode", "agc",
              "--model-ema", "--model-ema-warmup", "--grad-accum-steps", "2"]
# the downstream run of the optimizer side: survival fine-tuning with SGD,
# the plateau schedule, the EMA and global-norm clipping
SURVIVAL_OPT_FLAGS = ["--opt", "sgd", "--use-sched", "--sched", "plateau", "--model-ema",
                      "--clip-grad", "1.0"]
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
# PPEG's bias gradient (kernel 5b) against the float64 sum of the gradient
# the kernel was given: its fp32 sum, then one rounding to bf16 (2^-9), so
# two bf16 roundings, 4e-3 relative Frobenius. The gradient it is given, the
# CLIP step's on the card against the CPU's fp32 path: cosine >= 0.999 (the
# CPU's plain bf16 path reads 0.99995 there; a lost pad, head or dkern
# moves it by O(1)).
BOUND_BIAS_SUM, BOUND_PPEG_G_COS = 4e-3, 0.999
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
    return smi


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
                "vit_fused.cu", "ln_qkv.cu", "conv1d.cu"):
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
    bound_ms, bound_by = bound(case.work["bytes"], case.work["mma"], case.work.get("fp32", 0),
                               case.work.get("mma_peak", PEAK_BF16_FLOPS))
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
    # the bound with the conv's products counted as fp32 FMAs (the earlier
    # CUDA-core slide's count), printed beside, kept out of the JSON
    if "fma_alt" in case.work:
        fma = case.work["fma_alt"]
        rate += (f"; its conv's products as fp32 FMAs bound it at "
                 f"{bound(case.work['bytes'], case.work['mma'] - fma, fma)[0]:.4f} ms")
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
        conv_mma = 2 * bh * n * dh * CONV_TAPS  # the conv's products, on the tensor cores
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
            dict(bytes=nbytes(q, k_l, w, v, kern, q), mma=attn_mma + conv_mma,
                 products=(2, 2), fma_alt=conv_mma)))
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
                dict(bytes=nbytes(v, kern, v), mma=fmas, fma_alt=fmas),
                library=lambda v=v, weight=weight, h=h: F.conv2d(
                    v, weight, padding=(CONV_TAPS // 2, 0), groups=h)))
            continue
        g = randn(*shape)
        # 9b on its launch wrapper (dv, the partials and their column sum into
        # buffers made here), as kernel 1 below: through the autograd
        # Function a call is host-bound (0.276 ms a call against 0.07 of
        # device time on an H100); the self-test's phase 8 runs that path
        dv, dkern = torch.empty_like(v), torch.empty(h, ksize, device=v.device)
        partial = conv1d.conv1d_bwd_scratch(v, ksize)

        def bwd9(v=v, kern16=kern16, g=g, dv=dv, dkern=dkern, partial=partial):
            conv1d.conv1d_bwd_into(v, kern16, g, dv, dkern, partial)
            return dv, dkern
        cases.append(Case(
            "conv1d_bwd", "conv1d.cu", "mirror_tpu/ops/conv1d_pallas.py:224", label, bwd9,
            lambda v=v, kern16=kern16, g=g: conv1d.depthwise_conv_seq_bwd_ref(v, kern16, g),
            BOUND_BWD, ("dv", "dkern"),
            dict(bytes=nbytes(v, kern, g, v, kern), mma=2 * fmas, fma_alt=2 * fmas),
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

    kernel = autograd_kernel(torch, fused, (x, ln_s, ln_b, w), g)
    # held by the batch sums, and a second run bit for bit (gw's row ranges
    # and the gs / gb partials summed in a fixed order, no atomics)
    sums = sum_check(torch, "ln_qkv_bwd", ("gx", "gs", "gb", "gw"), (1, 2, 3))
    again = same_bits_check(torch, "ln_qkv_bwd", kernel)
    return Case(
        "ln_qkv_bwd", "ln_qkv.cu", "mirror_tpu/ops/ln_qkv_pallas.py:157", label,
        kernel, plain, BOUND_BWD, ("gx", "gs", "gb", "gw"),
        dict(bytes=2 * nbytes(x, ln_s, ln_b, w) + qkv_bytes, mma=4 * rows * EMBED * n3,
             fp32=16 * rows * EMBED),
        library=autograd_kernel(torch, two_calls, (x, s16, b16, w), g),
        check=lambda out, ref: sums(out, ref) and again(out, ref))


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
        BOUND_BWD, ("dv",), dict(bytes=2 * nbytes(v), mma=2 * CONV_TAPS * v.numel(),
                                 fma_alt=2 * CONV_TAPS * v.numel()),
        library=lambda: torch.ops.aten.convolution_backward(
            g, v, taps.view(h, 1, CONV_TAPS, 1), None, [1, 1], [CONV_TAPS // 2, 0], [1, 1],
            False, [0, 0], h, [True, False, False])[0],
        # bit for bit the fused kernel's dv
        check=lambda out, ref: bool(torch.equal(out, dv))))
    cases.append(Case(
        "column_sum", ("common.cuh", "conv1d.cu"), "scripts/exp_conv_parts.py:55",
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
                 mma=5 * 2 * bh * n * m * dh + 2 * 2 * bh * n * dh * CONV_TAPS,
                 products=(7, 5), fma_alt=2 * 2 * bh * n * dh * CONV_TAPS),
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
    merged = {}
    merge_shapes(merged, results)
    return list(merged.values())


def merge_shapes(merged: dict, results) -> None:
    """Fold run_case's results into ``merged`` (name -> the kernel's JSON
    line): a new name's first result starts its line, a later shape's times
    go under its "by_shape", and the errors are the worst of all."""
    keep = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "rel_fro_err", "library_ratio")
    for r in results:
        if r["name"] not in merged:
            merged[r["name"]] = dict(r, checked=[r["shape"]], by_shape=[])
            continue
        first = merged[r["name"]]  # a run_case result, or a line merged before
        first.setdefault("checked", [first["shape"]]).append(r["shape"])
        first.setdefault("by_shape", []).append({k: r[k] for k in keep})
        first["max_abs_err"] = max(first["max_abs_err"], r["max_abs_err"])
        first["rel_fro_err"] = max(first["rel_fro_err"], r["rel_fro_err"])


def write_cohort(root: Path, n_slides: int, prefix: str):
    """n_slides slides of 1000-4000 Phikon-width patches (fp16 values stored
    as float32 .npy, the C++ gather's format), an RNA CSV with 10234 genes,
    all from numpy generators seeded with SEED."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(SEED)
    feat_dir = root / "features"
    feat_dir.mkdir()
    ids = [f"TCGA-{prefix}-{i:04d}-01Z-00-DX1" for i in range(n_slides)]
    for sid in ids:
        n = int(rng.integers(1000, 4001))
        np.save(feat_dir / f"{sid}.npy",
                rng.standard_normal((n, 768), dtype=np.float32).astype(np.float16)
                .astype(np.float32))
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
    # that launched them, nor a user annotation's span over them, which
    # would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    total = sum(dev_us(e) for e in events) / 1e3
    if total == 0:
        say(f"[{tag}] profiler: no device time recorded (time with CUDA events instead)")
        return
    say(f"[{tag}] profiler, one {what}: {total:.3f} ms of device time against a {what} of "
        f"{step_ms:.3f} ms (busy {100 * total / step_ms:.1f} %); by kernel:")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        say(f"[{tag}]   {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / 1e3 / total:5.1f} % "
            f"x{e.count:<4d} {e.key[:90]}")


def compute_dtype(torch, model) -> str:
    """The compute dtype a model was built with: its first module's."""
    dtype = next((m.dtype for m in model.modules() if getattr(m, "dtype", None) is not None),
                 torch.float32)
    return {torch.bfloat16: "bf16", torch.float32: "fp32", torch.float16: "fp16"}.get(
        dtype, str(dtype))


def kernel_fed(name: str) -> bool:
    """The leaves whose gradients only the backward kernels feed."""
    return "res_conv.weight" in name or "to_qkv.weight" in name or "pos_layer.proj" in name


def step_card_vs_cpu(torch, tag, make_step, batch, n_leaves, bars=None):
    """One train step at batch 2: the card's kernels against the CPU's plain
    path, same weights and draws, dropout 0. ``make_step(device, generator)``
    builds the model (its weights drawn from ``generator`` when one is
    given) and returns (model, step); ``step(batch)`` runs on ``batch`` moved
    to the device. Holds the loss and the gradients that only the backward
    kernels feed (res_conv, to_qkv, the PPEG convs: ``n_leaves`` of them),
    at ``bars`` (loss, gradient cosine, norm ratio; phase 5's by default)."""
    bound_loss, bound_cos, bound_norm = bars or (BOUND_STEP_LOSS, BOUND_GRAD_COS,
                                                 BOUND_GRAD_NORM)
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
                 if p.grad is not None and kernel_fed(name)}
        results[device] = (float(metrics["loss"]), grads, compute_dtype(torch, model))
        del model, step
    loss_gpu, g_gpu, card = results["cuda"]
    loss_cpu, g_cpu, ref = results["cpu"]
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    say(f"[{tag}] one step at batch 2, card kernels ({card}) vs CPU plain path ({ref}): loss "
        f"{loss_gpu:.6g} vs {loss_cpu:.6g}, relative error {rel:.4g} (bound "
        f"{bound_loss:g}); {time.perf_counter() - t0:.1f} s")
    if not np.isfinite(loss_gpu) or rel > bound_loss:
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
        if not (cos >= bound_cos and abs(ratio - 1.0) <= bound_norm):
            fail(f"[{tag}] gradient of {name} on the card disagrees with the CPU reference")
    return min(worst), rel


def train_step_card_vs_cpu(torch, model_kwargs, args, wsi, rna, tag="train", bars=None,
                           cpu_float32=False):
    """The MIRROR train step at batch 2, card against CPU, with the same
    masking noise and VAE eps; with ``cpu_float32`` the CPU's model computes
    in float32 whatever the card's type."""
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
        kw_dev = {k: v for k, v in kw.items() if k != "dtype"} \
            if cpu_float32 and device == "cpu" else kw
        model = create_model("mirror", device=device, generator=generator, **kw_dev)
        step = make_mirror_train_step(model, make_optimizer(args, model, 2e-5),
                                      loss_weights_from_args(args), args.wsi_mask_ratio,
                                      args.rna_mask_ratio)
        dev_noise = {k: torch.from_numpy(v).to(device) for k, v in noise.items()}
        return model, lambda b: step(b, noise=dev_noise)

    return step_card_vs_cpu(torch, tag, make_step, batch, 3 * 2 + 6, bars)


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


def max_diff(torch, a: dict, b: dict) -> float:
    """The largest |a - b| over the tensors of two dicts with the same keys."""
    if set(a) != set(b):
        fail(f"[run control] the states hold other keys: {sorted(set(a) ^ set(b))[:5]}")
    return max((float((a[k].float() - b[k].float()).abs().max()) for k in a), default=0.0)


def nondeterministic_ops(torch, step, batch):
    """The ops of one step that PyTorch knows not to repeat bit for bit,
    named by its deterministic-algorithms check (warnings only)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0][:80] for w in caught
                   if "deterministic" in str(w.message)})


def sigterm_on_step(module, name, at_step):
    """Replace ``module.name``, a train-step factory, by one whose step
    sends this process a SIGTERM from within its ``at_step``-th call;
    returns the original."""
    import os
    import signal

    real = getattr(module, name)
    calls = [0]

    def factory(*a, **k):
        step = real(*a, **k)

        def wrapped(*sa, **sk):
            calls[0] += 1
            out = step(*sa, **sk)
            if calls[0] == at_step:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped

    setattr(module, name, factory)
    return real


def grad_checkpointing_step(torch, model_kwargs, args, batch, exact: bool):
    """One MIRROR step without and with --grad-checkpointing on the same
    batch, weights and step generator state, each step's launches counted
    from 0 just before it; then each step timed (ms, peak memory). Returns
    (plain launches, checkpointed launches, the gradients' largest
    difference and worst cosine, times and peaks)."""
    from mirror_tpu_torch import train_mirror
    from mirror_tpu_torch.ops import _common
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_mirror_train_step

    kw = dict(model_kwargs, pinv_grad="exact" if exact else "implicit")
    state, out = None, {}
    for ckpt in (False, True):
        model = create_model("mirror", device="cuda",
                             generator=None if state else torch.Generator().manual_seed(SEED),
                             **dict(kw, grad_checkpointing=ckpt))
        if state is None:
            state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        step = make_mirror_train_step(
            model, make_optimizer(args, model, 2e-5), train_mirror.loss_weights_from_args(args),
            args.wsi_mask_ratio, args.rna_mask_ratio,
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        _common.reset_launch_counts()
        metrics = step(batch)
        torch.cuda.synchronize()
        launches = _common.launch_counts()
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        ms = peak = None
        if not exact:
            ms, _, _, peak, _ = time_steps(torch, step, batch, reps=5)
        out[ckpt] = dict(loss=float(metrics["loss"]), launches=launches, grads=grads, ms=ms,
                         peak_gib=peak)
        del model, step
        torch.cuda.empty_cache()
    a, b = out[False]["grads"], out[True]["grads"]
    cos = min(float(a[k].ravel() @ b[k].ravel() / (a[k].norm() * b[k].norm()).clamp_min(1e-30))
              for k in a if a[k].norm() > 0)
    return out[False], out[True], max_diff(torch, a, b), cos


def phase_run_control(torch, root: Path, feat_dir: Path, rna_csv: Path, model_kwargs):
    """The run control on the card at full width, on phase 5's cohort
    (32 slides, 2 steps of 16 an epoch): the loader's C++ gather taken and
    its host ms per batch against the numpy path's; 2 epochs straight (the
    second under --profile, whose trace must name the csrc kernels) against
    1 epoch and --resume for the second; a SIGTERM from within a step and
    its recovery file reloaded; one step with and without
    --grad-checkpointing (the gradients held, the launches of the table in
    PERF.md §6, peak memory and ms of both), and one with the exact pinv
    gradient (2b not recomputed); a checkpoint save with the optimizer's
    state timed. Returns the checkpointed step's launches."""
    import pandas as pd

    from mirror_tpu_torch import train_mirror
    from mirror_tpu_torch.config import parse_args
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train import harness
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import ModelEma

    t0 = time.perf_counter()
    split_dir = root / "splits_rc"
    split_dir.mkdir(parents=True)
    ids = sorted(p.stem[:12] for p in feat_dir.glob("*.npy"))[:RC_STEPS * B]
    pd.DataFrame({"train": ids, "val": [None] * len(ids)}).to_csv(split_dir / "splits_0.csv")

    # the loader: the C++ gather on the .npy cohort (the train runs so far
    # took it: no fallback said), its host ms per batch (assembly alone, no
    # prefetch) against the numpy path's
    from mirror_tpu_torch.data import loader as loader_mod

    if loader_mod._said:
        fail(f"[run control] a train run stepped back to the numpy path: {loader_mod._said}")
    dataset = PretrainDataset(str(feat_dir), str(rna_csv), N_TOKENS, splits=str(split_dir))
    per_batch = {}
    for native in (True, False):
        loader = Loader(dataset, B, seed=SEED, workers=8, prefetch=0, use_native=native)
        if loader.native is not native:
            fail(f"[run control] the loader's native path is {loader.native}, asked {native}")
        it = iter(loader)
        times = []
        for _ in range(RC_STEPS):
            t1 = time.perf_counter()
            host = next(it)
            times.append(1e3 * (time.perf_counter() - t1))
        it.close()
        per_batch["native" if native else "numpy"] = statistics.median(times)
    say(f"[run control] loader host ms per batch of {B} x {N_TOKENS} x 768 (median of "
        f"{RC_STEPS}, no prefetch): C++ gather {per_batch['native']:.2f}, numpy path "
        f"{per_batch['numpy']:.2f}")

    argv = ["--config", str(PRETRAIN_YAML), "--wsi-feature-dir", str(feat_dir),
            "--rna-feature-csv", str(rna_csv), "--split-dir", str(split_dir), "--fold-nb", "0",
            "--output", str(root / "runs"), "--no-val", "--batch-size", str(B),
            "--log-interval", "1", "--seed", str(SEED), "--workers", "8", "--model-ema",
            "--checkpoint-hist", "1"]
    run_entry_point(torch, "resume straight", train_mirror.main,
                                  argv + ["--experiment", "straight", "--epochs", "2",
                                          "--profile"], 2 * RC_STEPS)
    straight = root / "runs" / "pretrain" / "straight"
    traces = list((straight / "profile").glob("*.json"))
    text = traces[0].read_text() if traces else ""
    named = [k for k in RC_TRACE_KERNELS if k in text]
    say(f"[run control] --profile trace {traces[0].name if traces else None} "
        f"({len(text) / 2**20:.1f} MiB) names {named}")
    if named != list(RC_TRACE_KERNELS):
        fail(f"[run control] the --profile trace lacks the csrc kernels "
             f"{sorted(set(RC_TRACE_KERNELS) - set(named))}")
    run_entry_point(torch, "resume first", train_mirror.main,
                    argv + ["--experiment", "resumed", "--epochs", "1"], RC_STEPS)
    resumed = root / "runs" / "pretrain" / "resumed"
    run_entry_point(torch, "resume second", train_mirror.main,
                    argv + ["--experiment", "resumed", "--epochs", "2", "--resume",
                            str(resumed / "last.pth.tar")], RC_STEPS)
    a, b = (load_checkpoint_file(str(d / "last.pth.tar")) for d in (straight, resumed))
    diffs = {"weights": max_diff(torch, a["state_dict"], b["state_dict"]),
             "ema": max_diff(torch, a["state_dict_ema"], b["state_dict_ema"])}
    for key in a["optimizer"]["state"]:
        diffs[f"moment {key}"] = max_diff(torch, a["optimizer"]["state"][key],
                                          b["optimizer"]["state"][key])
    counts = [(x["optimizer"]["count"], x["step"]) for x in (a, b)]
    losses = [pd.read_csv(d / "summary.csv")["train_loss"].tolist() for d in (straight, resumed)]
    say(f"[run control] 2 epochs straight against 1 + --resume: largest difference "
        f"{json.dumps(diffs)}; (count, step) {counts}; train loss by epoch {losses}")
    if counts[0] != counts[1] or counts[0][0] != 2 * RC_STEPS:
        fail(f"[run control] the resumed run's counts {counts[1]} are not {counts[0]}")
    if max(diffs.values()) == 0.0 and losses[0] == losses[1]:
        say("[run control] the resumed run is the uninterrupted run bit for bit")
    else:
        # the step's bars, and the ops PyTorch knows not to repeat
        rel = abs(losses[0][1] - losses[1][1]) / abs(losses[0][1])
        cos = min(float(a["state_dict"][k].float().ravel() @ b["state_dict"][k].float().ravel()
                        / (a["state_dict"][k].float().norm() * b["state_dict"][k].float().norm())
                        .clamp_min(1e-30)) for k in a["state_dict"]
                  if a["state_dict"][k].float().norm() > 0)
        args, _ = parse_args(argv)
        model = create_model("mirror", device="cuda",
                             generator=torch.Generator().manual_seed(SEED), **model_kwargs)
        from mirror_tpu_torch.train.steps import make_mirror_train_step
        step = make_mirror_train_step(model, make_optimizer(args, model, 2e-5),
                                      train_mirror.loss_weights_from_args(args),
                                      generator=torch.Generator(device="cuda").manual_seed(SEED))
        batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        ops = nondeterministic_ops(torch, step, batch)
        del model, step, batch
        say(f"[run control] not bit for bit: loss relative {rel:.3g} (bound "
            f"{BOUND_STEP_LOSS:g}), weight cosine min {cos:.6f} (bound {BOUND_GRAD_COS}); "
            f"ops that do not repeat: {ops}")
        if not (rel <= BOUND_STEP_LOSS and cos >= BOUND_GRAD_COS):
            fail("[run control] the resumed run left the uninterrupted run's bars")

    # a SIGTERM from within the first step: the recovery file, reloaded
    real = sigterm_on_step(train_mirror, "make_mirror_train_step", 1)
    try:
        results, _ = run_entry_point(torch, "sigterm", train_mirror.main,
                                     argv + ["--experiment", "sigterm", "--epochs", "2"], 1)
    finally:
        train_mirror.make_mirror_train_step = real
    recovery = root / "runs" / "pretrain" / "sigterm" / "recovery.pth.tar"
    if results.get("preempted") is not True or not recovery.exists():
        fail(f"[run control] SIGTERM: --result {results}, recovery file {recovery.exists()}")
    args, _ = parse_args(argv)
    model = create_model("mirror", device="cuda", **model_kwargs)
    optimizer = make_optimizer(args, model, 2e-5)
    ema = ModelEma(model)
    from mirror_tpu_torch.train.checkpoint import resume_checkpoint
    start = resume_checkpoint(str(recovery), model, optimizer, ema)
    say(f"[run control] SIGTERM in step 1: --result {json.dumps(results)}; recovery.pth.tar "
        f"({recovery.stat().st_size / 2**20:.0f} MiB) reloads: start epoch {start}, count "
        f"{optimizer.count}, EMA updates {ema.updates}")
    if (start, optimizer.count, ema.updates) != (1, 1, 1):
        fail("[run control] the recovery file does not hold the first step's state")

    # the cost of a save with the optimizer's state (weights, EMA, 2 moments)
    save_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        harness.save_epoch([str(root / "save.pth.tar")], model, ema, args, 0, None, optimizer)
        save_ms.append(1e3 * (time.perf_counter() - t1))
    size = (root / "save.pth.tar").stat().st_size
    say(f"[run control] a checkpoint save with the optimizer's state: "
        f"{sum(p.numel() for p in model.parameters())} parameters, {size / 2**20:.0f} MiB, "
        f"median {statistics.median(save_ms):.1f} ms of 3 (host clock, page cache warm)")
    del model, optimizer, ema
    torch.cuda.empty_cache()

    # one step without and with --grad-checkpointing
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    plain, ckpt, diff, cos = grad_checkpointing_step(torch, model_kwargs, args, batch, False)
    say(f"[train_gradckpt] one step at batch {B}: loss {plain['loss']:.6g} / "
        f"{ckpt['loss']:.6g}, gradients largest difference {diff:.3g}, cosine min {cos:.6f}; "
        f"plain {plain['ms']:.3f} ms, peak {plain['peak_gib']:.2f} GiB; checkpointed "
        f"{ckpt['ms']:.3f} ms, peak {ckpt['peak_gib']:.2f} GiB; launches "
        f"{json.dumps(plain['launches'])} -> {json.dumps(ckpt['launches'])}")
    if not (diff == 0.0 or (cos >= BOUND_GRAD_COS and abs(plain["loss"] - ckpt["loss"])
                            <= BOUND_STEP_LOSS * abs(plain["loss"]))):
        fail("[train_gradckpt] the checkpointed step's gradients are not the plain step's")
    want = {k: 3 for k in FORWARD[:4] + BACKWARD[:3]}
    want.update({PINV_GEMM: 72, "ppeg": 1, "ppeg_bwd": 1})
    got_plain = {k: plain["launches"].get(k, 0) for k in want}
    got_ckpt = {k: ckpt["launches"].get(k, 0) for k in want}
    want_ckpt = {k: 2 * v if k in FORWARD[:4] + (PINV_GEMM,) else v for k, v in want.items()}
    if got_plain != want or got_ckpt != want_ckpt:
        fail(f"[train_gradckpt] launches {got_plain} -> {got_ckpt}, expected {want} -> "
             f"{want_ckpt}")
    plain_x, ckpt_x, diff_x, cos_x = grad_checkpointing_step(torch, model_kwargs, args, batch,
                                                             True)
    say(f"[train_gradckpt] --pinv-grad exact: gradients largest difference {diff_x:.3g}, "
        f"cosine min {cos_x:.6f}; {PINV_BWD} {plain_x['launches'].get(PINV_BWD, 0)} -> "
        f"{ckpt_x['launches'].get(PINV_BWD, 0)}, moore_penrose_pinv "
        f"{plain_x['launches'].get(FORWARD[1], 0)} -> {ckpt_x['launches'].get(FORWARD[1], 0)}")
    if ckpt_x["launches"].get(PINV_BWD, 0) != 3 or ckpt_x["launches"].get(FORWARD[1]) != 6:
        fail("[train_gradckpt] --pinv-grad exact: 2b must launch 3 times a step and the pinv "
             "forward 6 with --grad-checkpointing")
    if not (diff_x == 0.0 or cos_x >= BOUND_GRAD_COS):
        fail("[train_gradckpt] --pinv-grad exact: the checkpointed gradients disagree")
    del batch
    torch.cuda.empty_cache()
    say(f"[run control] {time.perf_counter() - t0:.1f} s")
    return ckpt["launches"], dict(loader_ms=per_batch, save_ms=statistics.median(save_ms),
                                  step_ms=(plain["ms"], ckpt["ms"]),
                                  peak_gib=(plain["peak_gib"], ckpt["peak_gib"]),
                                  resume_diff=max(diffs.values()))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def first_difference(torch, a: dict, b: dict):
    """The first key (in a's order) whose tensors differ in shape or bits,
    or None."""
    for key, value in a.items():
        if key not in b or b[key].shape != value.shape or not torch.equal(b[key], value):
            return key
    return None


def ddp_ranks(torch, root: Path, name, spec, argv, ranks: int, backend: str):
    """``ranks`` processes of ``parallel/worker.py`` over ``backend``; their
    outputs."""
    from mirror_tpu_torch.parallel import worker

    path = root / f"{name}.spec.pt"
    torch.save(dict(spec, argv=argv), path)
    try:
        return worker.launch(path, root / name, ranks, root / f"{name}.rdv", DDP_TIMEOUT_S,
                             env={"MIRROR_DIST_BACKEND": backend, "OMP_NUM_THREADS": "4"})
    except RuntimeError as e:
        fail(f"[ddp] the ranks of {name} failed: {str(e)[-3000:]}")


def grad_agreement(grads, ref):
    """The worst cosine (and its leaf) and the norm ratio furthest from 1
    of ``grads`` against ``ref`` over ref's nonzero leaves."""
    worst, worst_leaf, worst_ratio = 1.0, None, 1.0
    for leaf, g in ref.items():
        a, b = grads[leaf].float().ravel(), g.float().ravel()
        if b.norm() == 0:
            continue
        cos = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-30))
        ratio = float(a.norm() / b.norm())
        if cos < worst:
            worst, worst_leaf = cos, leaf
        if abs(ratio - 1.0) > abs(worst_ratio - 1.0):
            worst_ratio = ratio
    return worst, worst_leaf, worst_ratio


def phase_ddp(torch, root: Path, feat_dir: Path, rna_csv: Path, model_kwargs):
    """Data parallelism on the one card: a one-rank NCCL group through
    ``train_mirror.main`` bit for bit the run without one, and two gloo
    processes against the one-process step (phase 5d in the docstring).
    Returns the one-rank run's launches."""
    import os

    import numpy as np
    import pandas as pd

    from mirror_tpu_torch import train_mirror
    from mirror_tpu_torch.config import parse_args
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader
    from mirror_tpu_torch.parallel import distributed
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_mirror_train_step

    t0 = time.perf_counter()
    split_dir = root / "splits_ddp"
    split_dir.mkdir(parents=True)
    ids = sorted(p.stem[:12] for p in feat_dir.glob("*.npy"))[:DDP_STEPS * B]
    pd.DataFrame({"train": ids, "val": [None] * len(ids)}).to_csv(split_dir / "splits_0.csv")
    argv = ["--config", str(PRETRAIN_YAML), "--wsi-feature-dir", str(feat_dir),
            "--rna-feature-csv", str(rna_csv), "--split-dir", str(split_dir), "--fold-nb", "0",
            "--output", str(root / "runs"), "--no-val", "--batch-size", str(B), "--epochs", "1",
            "--log-interval", "1", "--seed", str(SEED), "--workers", "8",
            "--checkpoint-hist", "1"]

    # one rank over NCCL (the JAX env contract, host:port) against no group
    run_entry_point(torch, "ddp plain", train_mirror.main, argv + ["--experiment", "plain"],
                    DDP_STEPS)
    env = {"MIRROR_COORDINATOR": f"localhost:{free_port()}", "MIRROR_NUM_PROCESSES": "1",
           "MIRROR_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        _, launches = run_entry_point(torch, "train_ddp", train_mirror.main,
                                      argv + ["--experiment", "one_rank"], DDP_STEPS)
    finally:
        for key in env:
            os.environ.pop(key)
    if distributed.initialized():
        fail("[ddp] train_mirror.main left its process group behind")
    runs = root / "runs" / "pretrain"
    losses = [pd.read_csv(runs / d / "summary.csv").filter(like="loss").iloc[0].tolist()
              for d in ("plain", "one_rank")]
    a, b = (load_checkpoint_file(str(runs / d / "last.pth.tar")) for d in ("plain", "one_rank"))
    leaf = first_difference(torch, a["state_dict"], b["state_dict"])
    say(f"[ddp] one NCCL rank (the DDP wrapper at world size 1; the cross-rank math runs in "
        f"the gloo pair below and under --ddp-ranks) against no group, {DDP_STEPS} "
        f"steps at batch {B}: losses {losses[1]} vs {losses[0]}; weights "
        f"{'bit for bit' if leaf is None else 'differ first at ' + leaf}")
    if losses[0] != losses[1] or leaf is not None:
        fail(f"[ddp] the one-rank NCCL run is not the plain run bit for bit (first leaf that "
             f"differs: {leaf}; losses {losses})")

    # the cost of DDP at world size 1: the group's init, the step with and without
    dataset = PretrainDataset(str(feat_dir), str(rna_csv), N_TOKENS, splits=str(split_dir))
    host = next(iter(Loader(dataset, B, shuffle=True, seed=SEED, workers=8)))
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    args, _ = parse_args(argv)
    times = {}
    for grouped in (False, True):
        if grouped:
            os.environ.update(dict(env, MIRROR_COORDINATOR=f"localhost:{free_port()}"))
        try:
            with contextlib.ExitStack() as stack:
                t1 = time.perf_counter()
                if grouped:
                    stack.enter_context(distributed.session(args, torch.device("cuda")))
                init_s = time.perf_counter() - t1
                model = create_model("mirror", device="cuda",
                                     generator=torch.Generator().manual_seed(SEED),
                                     **model_kwargs)
                step = make_mirror_train_step(
                    model, make_optimizer(args, model, 2e-5),
                    train_mirror.loss_weights_from_args(args), args.wsi_mask_ratio,
                    args.rna_mask_ratio,
                    generator=torch.Generator(device="cuda").manual_seed(SEED))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step(batch)
                torch.cuda.synchronize()
                first_ms = 1e3 * (time.perf_counter() - t1)
                ms, _, _, _, _ = time_steps(torch, step, batch, reps=5, warm=1)
                times["nccl_1" if grouped else "no_group"] = dict(
                    init_s=init_s, first_step_ms=first_ms, step_ms=ms)
                del model, step
        finally:
            for key in env:
                os.environ.pop(key, None)
    torch.cuda.empty_cache()
    say(f"[ddp] one rank, batch {B}: no group: first step "
        f"{times['no_group']['first_step_ms']:.1f} ms, median {times['no_group']['step_ms']:.3f}"
        f" ms of 5; NCCL group of 1 (DDP): init {times['nccl_1']['init_s']:.2f} s, first step "
        f"{times['nccl_1']['first_step_ms']:.1f} ms, median {times['nccl_1']['step_ms']:.3f} ms "
        f"of 5 (CUDA events; the first steps on the host clock)")

    del batch
    # two gloo processes on the one card against the one-process step
    pairs = ddp_group_check(torch, root, host, args, model_kwargs, 2, "gloo")
    say(f"[ddp] phase {time.perf_counter() - t0:.1f} s")
    return launches, dict(times=times, pairs=pairs)


def group_reference(torch, host, args, model_kwargs, **spec_extra):
    """The worker's spec of one step on ``host`` (dropout 0, the masking
    noise and eps drawn here and injected, global negatives, its gradients
    dumped) and the one-process step on the card from the same weights,
    batch and draws: (spec, loss, {leaf: gradient}, bytes of the weights)."""
    import numpy as np

    from mirror_tpu_torch import train_mirror
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_mirror_train_step

    kw = dict(model_kwargs, wsi_dropout=0.0, rna_proj_drop_rate=0.0)
    rng = np.random.default_rng(SEED)
    noise = dict(wsi_noise=rng.random((B, N_TOKENS), dtype=np.float32),
                 rna_noise=rng.random((B, EMBED), dtype=np.float32),
                 wsi_eps=rng.standard_normal((B, 128), dtype=np.float32),
                 rna_eps=rng.standard_normal((B, 128), dtype=np.float32))
    noise = {k: torch.from_numpy(v) for k, v in noise.items()}
    weights = train_mirror.loss_weights_from_args(args)
    spec = dict(model="mirror", model_kwargs=kw, device="cuda", seed=SEED, step="mirror",
                negatives="global", lr=2e-5, loss_weights=tuple(weights),
                mask_ratios=(args.wsi_mask_ratio, args.rna_mask_ratio),
                batches=[{k: torch.from_numpy(host[k]) for k in ("wsi", "rna")}],
                noise=[noise], dump=("grads",), reps=DDP_REPS, **spec_extra)
    model = create_model("mirror", device="cuda", generator=torch.Generator().manual_seed(SEED),
                         **kw)
    step = make_mirror_train_step(model, make_optimizer(args, model, 2e-5), weights,
                                  args.wsi_mask_ratio, args.rna_mask_ratio)
    batch = {k: torch.from_numpy(host[k]).cuda() for k in ("wsi", "rna")}
    ref_loss = float(step(batch, noise={k: v.cuda() for k, v in noise.items()})["loss"])
    ref = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
           if p.grad is not None}
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    del model, step, batch
    torch.cuda.empty_cache()
    return spec, ref_loss, ref, param_bytes


def ddp_group_check(torch, root: Path, host, args, model_kwargs, ranks: int, backend: str,
                    model_parallel: int = 1):
    """``ranks`` processes of ``parallel/worker.py`` over ``backend`` (gloo:
    all on the one card; nccl: one a card), at ``--model-parallel
    model_parallel``, a global batch of ``B`` split evenly over the data
    ranks with global negatives, the masking noise and eps injected and
    dropout 0, against the one-process step on the card from the same
    weights, batch and draws at phase 5's bars (the gradients gathered
    whole); the ranks' weights the same bits after the update; then again
    with ``--optimizer-sharding``. Returns the times of each run."""
    import numpy as np

    spec, ref_loss, ref, _ = group_reference(torch, host, args, model_kwargs,
                                             model_parallel=model_parallel)
    data = ranks // model_parallel
    runs = {}
    for zero1 in (False, True):
        name = f"{backend}_{ranks}{f'_mp{model_parallel}' if model_parallel > 1 else ''}" \
            f"{'_zero1' if zero1 else ''}"
        outs = ddp_ranks(torch, root, name, spec, ["--config", str(PRETRAIN_YAML)]
                         + (["--optimizer-sharding"] if zero1 else []), ranks, backend)
        same = len({o["digests"][0] for o in outs}) == 1 and \
            len({o["init_digest"] for o in outs}) == 1
        loss = outs[0]["metrics"][0]["loss"]
        rel = abs(loss - ref_loss) / abs(ref_loss)
        grads = outs[0]["grads"]
        if set(grads) != set(ref):
            fail(f"[ddp] {name}: gradient leaves differ: {sorted(set(grads) ^ set(ref))[:5]}")
        worst, worst_leaf, worst_ratio = grad_agreement(grads, ref)
        runs[name] = dict(init_s=[o["init_s"] for o in outs],
                          first_step_ms=[o["first_step_ms"] for o in outs],
                          step_ms=[o["step_ms"] for o in outs], digest=outs[0]["digests"][0])

        def spread(key, fmt):
            return " / ".join(format(v, fmt) for v in runs[name][key])

        say(f"[ddp] {name}: {ranks} processes over {backend} (data {data} x model "
            f"{model_parallel}), batch {B} as {data} x {B // data}, global negatives: loss "
            f"{loss:.6g} vs one process {ref_loss:.6g} "
            f"(relative {rel:.3g}, bound {BOUND_STEP_LOSS:g}); averaged gradients over "
            f"{len(ref)} leaves, worst cosine {worst:.6f} ({worst_leaf}), norm ratio furthest "
            f"from 1 {worst_ratio:.5f} (bounds {BOUND_GRAD_COS}, {BOUND_GRAD_NORM:g}); the "
            f"ranks' weights {'the same bits' if same else 'DIFFER'} after the update; init "
            f"{spread('init_s', '.2f')} s, first step {spread('first_step_ms', '.1f')} ms, "
            f"median {spread('step_ms', '.3f')} ms of {DDP_REPS} (host clock around a "
            f"synchronized step)")
        if not same:
            fail(f"[ddp] {name}: the ranks' weights differ after the update")
        if not (np.isfinite(loss) and rel <= BOUND_STEP_LOSS and worst >= BOUND_GRAD_COS
                and abs(worst_ratio - 1.0) <= BOUND_GRAD_NORM):
            fail(f"[ddp] {name}: the averaged gradients leave the one-process step's bars")
    names = list(runs)
    zero1_same = runs[names[0]]["digest"] == runs[names[1]]["digest"]
    say(f"[ddp] ZeRO-1's weights after the update {'are' if zero1_same else 'are not'} the "
        f"unsharded run's bits")
    if not zero1_same:
        fail(f"[ddp] {names[1]}: ZeRO-1's weights after the update are not the unsharded "
             f"run's bits")
    return runs


def phase_ddp_cards(torch, ranks: int) -> None:
    """``chip_smoke.py --ddp-ranks R`` on R cards of one host: the kernels
    built, phase 5's cohort written, and :func:`ddp_group_check` with one
    process a card over NCCL; then again at data R / 2 x model 2."""
    from mirror_tpu_torch.config import model_kwargs_from_args, parse_args
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader

    if torch.cuda.device_count() < ranks:
        fail(f"--ddp-ranks {ranks}: {torch.cuda.device_count()} card(s)")
    phase_build()
    args, _ = parse_args(["--config", str(PRETRAIN_YAML)])
    kw = dict(model_kwargs_from_args(args), rna_embed_dim=RNA_DIM, wsi_num_tokens=N_TOKENS)
    build_root = REPO / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        feat_dir, rna_csv, split_dir = write_pretrain_cohort(Path(tmp))
        dataset = PretrainDataset(str(feat_dir), str(rna_csv), N_TOKENS, splits=str(split_dir))
        host = next(iter(Loader(dataset, B, shuffle=True, seed=SEED, workers=8)))
        ddp_group_check(torch, Path(tmp), host, args, kw, ranks, "nccl")
        if ranks % TP_MODEL_PARALLEL == 0 and ranks > TP_MODEL_PARALLEL:
            ddp_group_check(torch, Path(tmp), host, args, kw, ranks, "nccl",
                            model_parallel=TP_MODEL_PARALLEL)


def phase_tp(torch, root: Path, feat_dir: Path, rna_csv: Path, model_kwargs):
    """Tensor parallelism on the one card (phase 5e in the docstring):
    ``train_mirror.main`` in one process, then at ``--model-parallel 2`` in
    two gloo processes, with and without ZeRO-1, and one injected step, in
    one spawn. Returns rank 0's launches of the model-parallel run."""
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch import train_mirror
    from mirror_tpu_torch.config import parse_args
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader
    from mirror_tpu_torch.parallel import worker
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args

    t0 = time.perf_counter()
    mp = TP_MODEL_PARALLEL
    split_dir = root / "splits_tp"
    split_dir.mkdir(parents=True)
    ids = sorted(p.stem[:12] for p in feat_dir.glob("*.npy"))[:DDP_STEPS * B]
    pd.DataFrame({"train": ids, "val": [None] * len(ids)}).to_csv(split_dir / "splits_0.csv")
    argv = ["--config", str(PRETRAIN_YAML), "--wsi-feature-dir", str(feat_dir),
            "--rna-feature-csv", str(rna_csv), "--split-dir", str(split_dir), "--fold-nb", "0",
            "--output", str(root / "runs"), "--no-val", "--batch-size", str(B), "--epochs", "1",
            "--log-interval", "1", "--seed", str(SEED), "--workers", "8",
            "--checkpoint-hist", "1", "--model-kwargs", "wsi_dropout=0.0",
            "rna_proj_drop_rate=0.0"]
    run_entry_point(torch, "tp one", train_mirror.main, argv + ["--experiment", "tp_one"],
                    DDP_STEPS)

    args, _ = parse_args(argv)
    dataset = PretrainDataset(str(feat_dir), str(rna_csv), N_TOKENS, splits=str(split_dir))
    host = next(iter(Loader(dataset, B, shuffle=True, seed=SEED, workers=8)))
    spec, ref_loss, ref, one_bytes = group_reference(torch, host, args, model_kwargs,
                                                     model_parallel=mp, ema=True,
                                                     argv=["--config", str(PRETRAIN_YAML)])
    tp_argv = argv + ["--model-parallel", str(mp)]
    cases = [dict(cli="mirror_tpu_torch.train_mirror", argv=tp_argv + ["--experiment", "tp"]),
             dict(cli="mirror_tpu_torch.train_mirror",
                  argv=tp_argv + ["--optimizer-sharding", "--experiment", "tp_zero1"]),
             spec]
    path = root / "tp.spec.pt"
    torch.save(dict(device="cuda", cases=cases), path)
    t1 = time.perf_counter()
    try:
        outs = worker.launch(path, root / "tp", mp, root / "tp.rdv", DDP_TIMEOUT_S,
                             env={"MIRROR_DIST_BACKEND": "gloo", "OMP_NUM_THREADS": "4"})
    except RuntimeError as e:
        fail(f"[tp] the ranks failed: {str(e)[-3000:]}")
    spawn_s = time.perf_counter() - t1
    cli, cli_zero1, step = ([o["cases"][i] for o in outs] for i in range(3))
    launches = cli[0]["launches"]
    say(f"[train_tp] train_mirror.main at --model-parallel {mp} in {mp} gloo processes on the "
        f"one card (data 1 x model {mp}), {DDP_STEPS} steps at batch {B}; rank 0's kernel "
        f"launches {json.dumps(launches)}; rank 1's {json.dumps(cli[1]['launches'])}")
    missing = [k for k in FORWARD + BACKWARD if launches.get(k, 0) == 0]
    if missing:
        fail(f"[tp] the model-parallel run never launched: {missing}")

    runs = root / "runs" / "pretrain"
    losses = {d: pd.read_csv(runs / d / "summary.csv").filter(like="loss").iloc[0]
              for d in ("tp_one", "tp", "tp_zero1")}
    rel = float(max(abs(losses["tp"][k] - v) / abs(v) for k, v in losses["tp_one"].items()
                    if v != 0))
    one, two, two_zero1 = (load_checkpoint_file(str(runs / d / "last.pth.tar"))
                           for d in ("tp_one", "tp", "tp_zero1"))
    kw = run_args(one)["model_kwargs"]
    init = create_model("mirror", device="cpu", generator=torch.Generator().manual_seed(SEED),
                        **kw).state_dict()
    shapes_same = {k: v.shape for k, v in two["state_dict"].items()} == \
        {k: v.shape for k, v in one["state_dict"].items()}
    worst, worst_leaf, ratio = grad_agreement(
        *({k: d[k].float() - v.float() for k, v in init.items()}
          for d in (two["state_dict"], one["state_dict"])))
    zero1_leaf = first_difference(torch, two["state_dict"], two_zero1["state_dict"])
    say(f"[tp] losses of the epoch (train_*_loss) at --model-parallel {mp} against one "
        f"process: worst relative {rel:.3g} (bound {TP_BOUND_EPOCH_LOSS:g}); the saved "
        f"weights {'at' if shapes_same else 'NOT at'} the one-process keys and shapes; each "
        f"leaf's update against one process's over {len(init)} leaves (not gated): worst "
        f"cosine {worst:.6f} ({worst_leaf}), norm ratio furthest from 1 {ratio:.5f}; "
        f"--optimizer-sharding's weights "
        f"{'the same bits' if zero1_leaf is None else 'differ first at ' + zero1_leaf}")
    if not shapes_same:
        fail("[tp] the model-parallel checkpoint is not at the one-process keys and shapes")
    if not (np.isfinite(rel) and rel <= TP_BOUND_EPOCH_LOSS):
        fail(f"[tp] the model-parallel run's losses are {rel:.3g} off one process's")
    if zero1_leaf is not None:
        fail(f"[tp] --optimizer-sharding changed the weights first at {zero1_leaf}")

    # the injected step: gradients, bytes a rank, the step's median
    same = len({o["digests"][0] for o in step}) == 1
    loss = step[0]["metrics"][0]["loss"]
    step_rel = abs(loss - ref_loss) / abs(ref_loss)
    g_worst, g_leaf, g_ratio = grad_agreement(step[0]["grads"], ref)
    sizes = {"parameters": (one_bytes, [o["param_bytes"] for o in step]),
             "Adam moments": (2 * one_bytes, [o["optimizer_bytes"] for o in step]),
             "EMA": (one_bytes, [o["ema_bytes"] for o in step])}
    medians = " / ".join(f"{o['step_ms']:.3f}" for o in step)
    say(f"[tp] one injected step at --model-parallel {mp}: loss {loss:.6g} vs one process "
        f"{ref_loss:.6g} (relative {step_rel:.3g}); gradients gathered whole over "
        f"{len(ref)} leaves, worst cosine {g_worst:.6f} ({g_leaf}), norm ratio furthest from "
        f"1 {g_ratio:.5f} (bounds {TP_BOUND_STEP_LOSS:g}, {TP_BOUND_GRAD_COS}, "
        f"{TP_BOUND_GRAD_NORM:g}); the ranks' weights {'the same bits' if same else 'DIFFER'}; "
        + "; ".join(f"{k} {' / '.join(f'{b / 2**20:.1f}' for b in per)} MiB a rank vs "
                    f"{whole / 2**20:.1f} MiB in one process" for k, (whole, per) in sizes.items())
        + f"; step median {medians} ms of {DDP_REPS} (host clock around a synchronized "
        f"step); spawn {spawn_s:.1f} s")
    if not (same and np.isfinite(loss) and step_rel <= TP_BOUND_STEP_LOSS
            and g_worst >= TP_BOUND_GRAD_COS and abs(g_ratio - 1.0) <= TP_BOUND_GRAD_NORM):
        fail(f"[tp] the model-parallel step leaves phase 5e's bars (loss {step_rel:.3g}, "
             f"worst leaf {g_leaf} at cosine {g_worst:.6f}, norm ratio {g_ratio:.5f})")
    if not all(max(per) < whole for whole, per in sizes.values()):
        fail(f"[tp] a rank holds as much as one process: {sizes}")
    say(f"[tp] phase {time.perf_counter() - t0:.1f} s")
    return launches, dict(loss_rel=rel, update_cos=worst, step_loss_rel=step_rel,
                          grad_cos=g_worst, bytes=sizes,
                          step_ms=[o["step_ms"] for o in step], spawn_s=spawn_s)


def clip_step_card_vs_cpu(torch, argv, wsi, rna):
    """The CLIP train step at batch 2 (the pretrain_clip run's arguments and
    widths, dropout 0), card against the CPU's plain path in fp32. Against
    the CPU in bf16 the PPEG biases' gradient is no reference: it is the sum
    of g over the 2 x 2116 grid tokens, where the cls-only loss leaves
    about 5 % of the sum of |g| (the softmax's key gradients cancel over the
    tokens), so each side's bf16 rounding moves it by a few percent, the
    CPU's bf16 path further from its fp32 than the card's kernels."""
    from mirror_tpu_torch.config import model_kwargs_from_args, parse_args
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_clip_train_step

    args, _ = parse_args(argv)
    kw = dict(model_kwargs_from_args(args), rna_embed_dim=RNA_DIM, wsi_dropout=0.0,
              rna_proj_drop_rate=0.0)
    batch = dict(wsi=torch.from_numpy(wsi[:2]), rna=torch.from_numpy(rna[:2]))

    def make_step(device, generator):
        model = create_model("mirror_dual", device=device, generator=generator,
                             **dict(kw, dtype="bfloat16" if device == "cuda" else "float32"))
        return model, make_clip_train_step(model, make_optimizer(args, model, args.lr),
                                           temperature=args.temperature)

    return step_card_vs_cpu(torch, "pretrain_clip", make_step, batch, 2 * 2 + 6)


def clip_bias_study(torch, argv, wsi, rna, seeds=4):
    """The PPEG biases' gradient of the CLIP step at batch 2 on ``seeds``
    (weights, batch) pairs: weights from seed SEED + s, rows 2s and 2s + 1
    of the batch, dropout 0; the card (kernels, bf16), the CPU's plain path
    in bf16 and in fp32. The bias gradient is the sum of g, the PPEG
    output's gradient, over the grid tokens, a sum that keeps a few percent
    of sum |g|: a bf16 path's g, at cosine 0.9999 of fp32's, moves it by
    percents, the CPU's plain bf16 path as far as the card (PERF.md, PR
    17). So each pair holds the two parts apart: 5b's sum on the card
    against the float64 sum of the g it was given (a fault of the
    reduction), and that g against fp32's (a fault upstream); fails if
    either is beyond its bar. Prints beside them the card's and the CPU
    bf16's bias gradient against fp32 (cosine, norm ratio) and how much of
    sum |g| the sum keeps. Returns the card's worst bias cosine."""
    from mirror_tpu_torch.config import model_kwargs_from_args, parse_args
    from mirror_tpu_torch.models import transmil
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_clip_train_step

    args, _ = parse_args(argv)
    kw = dict(model_kwargs_from_args(args), rna_embed_dim=RNA_DIM, wsi_dropout=0.0,
              rna_proj_drop_rate=0.0)
    leaf = "wsi_encoder.pos_layer.proj.bias"
    seen = {}
    plain_fused = transmil.ppeg_fused

    def spy(img, kern, bias):
        out = plain_fused(img, kern, bias)
        out.register_hook(lambda g: seen.__setitem__("g", g.detach().double().cpu()))
        bias.register_hook(lambda d: seen.__setitem__("db", d.detach().double().cpu()))
        return out

    def cos(a, b):
        return (a @ b / (a.norm() * b.norm())).item()

    worst, bad = 1.0, []
    transmil.ppeg_fused = spy
    try:
        for s in range(seeds):
            batch = dict(wsi=torch.from_numpy(wsi[2 * s:2 * s + 2]),
                         rna=torch.from_numpy(rna[2 * s:2 * s + 2]))
            state, runs = None, {}
            for run, device, dtype in (("card", "cuda", "bfloat16"), ("bf16", "cpu", "bfloat16"),
                                       ("fp32", "cpu", "float32")):
                gen = None if state else torch.Generator().manual_seed(SEED + s)
                model = create_model("mirror_dual", device=device, generator=gen,
                                     **dict(kw, dtype=dtype))
                if state is None:
                    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
                else:
                    model.load_state_dict(state)
                step = make_clip_train_step(model, make_optimizer(args, model, args.lr),
                                            temperature=args.temperature)
                step({k: v.to(device) for k, v in batch.items()})
                grad = dict(model.named_parameters())[leaf].grad.detach().double().cpu()
                runs[run] = dict(grad=grad, g=seen["g"], db=seen["db"])
                del model, step
            card, bf16, fp32 = runs["card"], runs["bf16"], runs["fp32"]
            g_sum = card["g"].sum((0, 1, 2))
            sum_err = ((card["db"] - g_sum).norm() / g_sum.norm()).item()
            keeps = (fp32["g"].sum((0, 1, 2)).norm()
                     / fp32["g"].abs().sum((0, 1, 2)).norm()).item()
            c_card, c_bf16 = cos(card["grad"], fp32["grad"]), cos(bf16["grad"], fp32["grad"])
            g_cos = cos(card["g"].ravel(), fp32["g"].ravel())
            r_card = (card["grad"].norm() / fp32["grad"].norm()).item()
            r_bf16 = (bf16["grad"].norm() / fp32["grad"].norm()).item()
            say(f"[pretrain_clip] PPEG bias gradient, seed {SEED + s}, rows {2 * s}-{2 * s + 1}: "
                f"card vs fp32 cosine {c_card:.6f}, norm ratio {r_card:.5f}; CPU bf16 vs fp32 "
                f"cosine {c_bf16:.6f}, norm ratio {r_bf16:.5f}; g card vs fp32 cosine "
                f"{g_cos:.6f} (bar {BOUND_PPEG_G_COS:g}), CPU bf16 vs fp32 "
                f"{cos(bf16['g'].ravel(), fp32['g'].ravel()):.6f}; the sum keeps "
                f"{100 * keeps:.2f} % of sum |g| (fp32); 5b's sum vs float64 sum of its g: "
                f"rel Frobenius err {sum_err:.3g} (bar {BOUND_BIAS_SUM:g})")
            if not sum_err <= BOUND_BIAS_SUM:
                bad.append(f"seed {SEED + s}: ppeg_bwd's bias sum is not the sum of its g")
            if not g_cos >= BOUND_PPEG_G_COS:
                bad.append(f"seed {SEED + s}: the g 5b is given against fp32's")
            worst = min(worst, c_card)
    finally:
        transmil.ppeg_fused = plain_fused
    if bad:
        fail(f"[pretrain_clip] PPEG bias gradient: {'; '.join(bad)}")
    return worst


def phase_pretrain_clip(torch, root: Path, feat_dir: Path, rna_csv: Path):
    """The CLIP baseline through ``train_pretrain.main`` on phase 5's cohort
    (48 slides train, 16 val) at full width with the optimizer side's flags
    (lamb, a cosine schedule on updates with a warmup epoch, AGC, the EMA
    with its ramp, accumulation 2): 2 epochs of 3 micro-batches, 3 real
    updates; its launches read around the run; the checkpoint with its EMA
    weights reloaded; one batch-2 step on the card against the CPU; the
    step timed per real update with and without the EMA and accumulation."""
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch import train_pretrain
    from mirror_tpu_torch.config import model_kwargs_from_args, parse_args
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import ModelEma, make_clip_train_step

    split_dir = root / "splits_clip"
    split_dir.mkdir(parents=True)
    ids = sorted(p.stem[:12] for p in feat_dir.glob("*.npy"))
    n_train = CLIP_MICRO_STEPS * B
    pd.DataFrame({"train": pd.Series(ids[:n_train]), "val": pd.Series(ids[n_train:])}).to_csv(
        split_dir / "splits_0.csv")
    argv = ["--config", str(PRETRAIN_YAML), "--wsi-feature-dir", str(feat_dir),
            "--rna-feature-csv", str(rna_csv), "--split-dir", str(split_dir), "--fold-nb", "0",
            "--output", str(root / "runs"), "--experiment", "clip", "--epochs", "2",
            "--batch-size", str(B), "--log-interval", "1", "--seed", str(SEED),
            "--workers", "8", *CLIP_FLAGS]
    results, launches = run_entry_point(torch, "pretrain_clip", train_pretrain.main, argv,
                                        2 * CLIP_MICRO_STEPS)
    run_dir = root / "runs" / "pretrain_clip" / "clip"
    summary = pd.read_csv(run_dir / "summary.csv")
    cols = ["train_loss", "train_lr", "eval_loss", "eval_ema_loss"]
    if len(summary) != 2 or not np.isfinite(summary[cols].to_numpy()).all():
        fail(f"[pretrain_clip] summary.csv: {summary.to_dict('list')}")
    if results.get("metric_name") != "loss" or not np.isfinite(results["best_metric"]):
        fail(f"[pretrain_clip] --result is not what a finished run prints: {results}")
    say(f"[pretrain_clip] --result {json.dumps(results)}; train lr by epoch "
        f"{summary['train_lr'].tolist()}, eval loss {summary['eval_loss'].tolist()}, EMA eval "
        f"loss {summary['eval_ema_loss'].tolist()}")
    # per micro-step: two of each Nystrom kernel forward and backward, one
    # PPEG and its backward; the forwards also run in the two evals (live
    # and EMA) of each epoch
    steps = 2 * CLIP_MICRO_STEPS
    want = {k: 2 * steps for k in BACKWARD if k != "ppeg_bwd"}
    want["ppeg_bwd"] = steps
    wrong = {k: launches.get(k, 0) for k, n in want.items() if launches.get(k, 0) != n}
    missing = [k for k in FORWARD if launches.get(k, 0) < (1 if k == "ppeg" else 2) * steps]
    if wrong or missing:
        fail(f"[pretrain_clip] backward launches {wrong} (want {want}); forwards short: "
             f"{missing}")

    payload = load_checkpoint_file(str(run_dir / "last.pth.tar"))
    if payload["arch"] != "mirror_dual" or "state_dict_ema" not in payload:
        fail("[pretrain_clip] last.pth.tar lacks the dual encoder or its EMA weights")
    model = create_model("mirror_dual", device="cuda", **run_args(payload)["model_kwargs"])
    model.load_state_dict(payload["state_dict_ema"])
    model.load_state_dict(payload["state_dict"])
    say(f"[pretrain_clip] last.pth.tar reloads into create_model('mirror_dual'), live and EMA "
        f"weights: {sum(p.numel() for p in model.parameters())} parameters")
    del model

    dataset = PretrainDataset(str(feat_dir), str(rna_csv), N_TOKENS, splits=str(split_dir))
    host = next(iter(Loader(dataset, B, shuffle=True, seed=SEED, workers=8)))
    cos, rel = clip_step_card_vs_cpu(torch, argv, host["wsi"], host["rna"])
    bias_cos = clip_bias_study(torch, argv, host["wsi"], host["rna"])

    # ms per real update at batch 16: the flags without the EMA and at k 1,
    # with the EMA at k 1, and with both (an update is then two steps)
    args, _ = parse_args(argv)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    kw = dict(model_kwargs_from_args(args), rna_embed_dim=RNA_DIM)
    timings = {}
    for name, use_ema, k in (("plain", False, 1), ("ema", True, 1), ("ema_accum2", True, 2)):
        args.grad_accum_steps = k
        model = create_model("mirror_dual", device="cuda",
                             generator=torch.Generator().manual_seed(SEED), **kw)
        ema = ModelEma(model, args.model_ema_decay, args.model_ema_warmup) if use_ema else None
        step = make_clip_train_step(model, make_optimizer(args, model, args.lr),
                                    temperature=args.temperature,
                                    generator=torch.Generator(device="cuda").manual_seed(SEED),
                                    ema=ema)

        def update(b, step=step, k=k):
            for _ in range(k):
                out = step(b)
            return out
        ms, lo, hi, peak, metrics = time_steps(torch, update, batch, reps=6)
        timings[name] = dict(ms=ms, peak_gib=peak)
        say(f"[pretrain_clip] CLIP train step at batch {B}, {name} (k {k}, EMA {use_ema}): "
            f"median {ms:.3f} ms per real update over 6 (min {lo:.3f}, max {hi:.3f}), "
            f"{1000 * B * k / ms:.1f} samples/s; peak device memory {peak:.2f} GiB; loss "
            f"{float(metrics['loss']):.6g}")
        if name == "plain":
            profile_step(torch, step, batch, ms, tag="pretrain_clip")
        del model, ema, step, update
        torch.cuda.empty_cache()

    # the optimizer side alone, on one step's gradients (the steps above
    # spread by more than it costs): an update at k 1, the EMA's update,
    # and at k 2 the pair of calls (a copy of the gradients, then their
    # running mean and the update)
    model = create_model("mirror_dual", device="cuda",
                         generator=torch.Generator().manual_seed(SEED), **kw)
    args.grad_accum_steps = 1
    make_clip_train_step(model, make_optimizer(args, model, args.lr),
                         temperature=args.temperature)(batch)
    ema = ModelEma(model, args.model_ema_decay, args.model_ema_warmup)
    opts = {}
    for k in (1, 2):
        args.grad_accum_steps = k
        opts[k] = make_optimizer(args, model, args.lr)
    alone = {
        "update": lambda _: opts[1].step(),
        "ema_update": lambda _: ema.update(),
        "accum2_pair": lambda _: (opts[2].step(), opts[2].step()),
    }
    for name, fn in alone.items():
        ms, lo, hi, _, _ = time_steps(torch, fn, None, reps=10)
        timings[name] = dict(ms=ms)
        say(f"[pretrain_clip] {name}: median {ms:.3f} ms over 10 (min {lo:.3f}, max {hi:.3f}), "
            f"{sum(p.numel() for p in model.parameters())} fp32 parameters")
    say(f"[pretrain_clip] what accumulation 2 adds to an update: "
        f"{timings['accum2_pair']['ms'] - timings['update']['ms']:.3f} ms (the pair less "
        f"one update); the EMA: {timings['ema_update']['ms']:.3f} ms")
    del model, ema, opts, alone, batch
    torch.cuda.empty_cache()
    return launches, dict(timings=timings, worst_grad_cos=cos, step_loss_rel=rel,
                          worst_bias_cos=bias_cos)


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
    loader, (optimizer, _, _), _ = train_loader_and_optimizer(args, dataset, model)
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
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file
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

    # the optimizer side on the card: survival fine-tuning with SGD, the
    # plateau schedule, the EMA (evaluated beside the live weights, saved
    # in the checkpoint) and global-norm clipping, implicit pinv gradient
    argv_opt = ["--config", str(survival_yaml), "--wsi-feature-dir", str(feat_dir),
                "--survival-csv", str(surv_csv), "--experiment", "survival_opt", *common,
                *SURVIVAL_OPT_FLAGS]
    results, launches["survival_opt"] = run_entry_point(torch, "survival_opt",
                                                        train_survival.main, argv_opt, steps)
    run_dir = root / "runs" / "survival" / "survival_opt"
    summary = pd.read_csv(run_dir / "summary.csv")
    cols = ["train_loss", "train_lr", "eval_loss", "eval_ema_loss"]
    if not np.isfinite(summary[cols].to_numpy()).all():
        fail(f"[survival_opt] summary.csv: {summary.to_dict('list')}")
    if "state_dict_ema" not in load_checkpoint_file(str(run_dir / "last.pth.tar")):
        fail("[survival_opt] last.pth.tar has no state_dict_ema")
    missing = [k for k in FORWARD + BACKWARD if launches["survival_opt"].get(k, 0) == 0]
    if missing:
        fail(f"[survival_opt] never launched: {missing}")
    say(f"[survival_opt] --result {json.dumps(results)}; plateau lr by epoch "
        f"{summary['train_lr'].tolist()}; EMA eval c-index "
        f"{summary['eval_ema_c-index'].tolist()}; last.pth.tar carries state_dict_ema")

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


# whole-slide encoding (phase 10): 4 synthetic slides of these patch
# counts (768-d, fp16 .npy), encoded whole at the subtyping template's width;
# the CP attention layer whose gradient the gloo pair takes has n rows (24
# landmark groups of 384), and the two slides predict scores; the ranks'
# launch time limit
WS_SLIDES = (2_000, 15_000, 40_000, 100_000)
WS_GRAD_N = 24 * M
WS_PREDICT = 2
WS_TIMEOUT_S = 300.0


def write_whole_slide_cohort(root: Path):
    """The slides of WS_SLIDES (fp16 .npy, from numpy seeded with SEED) and,
    for predict, the first WS_PREDICT of them in their own folder with an
    RNA CSV."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(SEED)
    feat_dir, pred_dir = root / "ws_features", root / "ws_predict"
    feat_dir.mkdir()
    pred_dir.mkdir()
    ids = [f"TCGA-WS-{i:04d}-01Z-00-DX1" for i in range(len(WS_SLIDES))]
    for i, (sid, n) in enumerate(zip(ids, WS_SLIDES)):
        feats = rng.standard_normal((n, EMBED), dtype=np.float32).astype(np.float16)
        np.save(feat_dir / f"{sid}.npy", feats)
        if i < WS_PREDICT:
            np.save(pred_dir / f"{sid}.npy", feats)
    pd.DataFrame(rng.standard_normal((WS_PREDICT, RNA_DIM), dtype=np.float32),
                 index=[s[:15] for s in ids[:WS_PREDICT]],
                 columns=[f"gene_{j}" for j in range(RNA_DIM)]).to_csv(root / "ws_rna.csv")
    return feat_dir, pred_dir, root / "ws_rna.csv", ids


def seq_agreement(torch, got, want):
    """(relative Frobenius error, worst row cosine) of a sequence against
    its reference, in fp32."""
    a, b = got.float(), want.float()
    rel = ((a - b).norm() / b.norm()).item()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    return rel, cos


def ws_attention(torch):
    """A CP attention layer at the slices' width (dim 768, 8 heads of 96, 384
    landmarks, bf16, the exact pinv gradient), its weights from SEED, and x
    and t [WS_GRAD_N, 768]."""
    from mirror_tpu_torch.models.nystrom import NystromAttention
    from mirror_tpu_torch.registry import init_weights

    kwargs = dict(dim=EMBED, dim_head=DH, heads=HEADS, num_landmarks=M, pinv_grad="exact",
                  dtype=torch.bfloat16)
    attn = NystromAttention(**kwargs)
    init_weights(attn, torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 1)
    x, t = (torch.randn(WS_GRAD_N, EMBED, generator=gen) for _ in range(2))
    return kwargs, attn.eval(), x, t


def cp_attention_here(torch, attn, x, t):
    """The CP attention without a group on the card: (out, dL/dx, the
    parameters' gradients), L = sum(out t)."""
    from mirror_tpu_torch.parallel.context_parallel import nystrom_attention_cp

    attn = attn.cuda()
    attn.zero_grad()
    xc = x.cuda().requires_grad_(True)
    out = nystrom_attention_cp(xc, attn)
    (out.float() * t.cuda()).sum().backward()
    grads = {n: p.grad.detach().float().cpu() for n, p in attn.named_parameters()}
    return out.detach().float().cpu(), xc.grad.float().cpu(), grads


def ws_kernel_cases(torch, patches: int):
    """Kernels 3, 3b, 9 and 5 at the shapes the whole-slide path gives them
    for a slide of ``patches`` patches (wrap-padded to a square grid, the
    cls row added, front-padded to a multiple of the landmarks; batch 1,
    one rank): kernel 3 as ``KvCombine`` launches it,
    keeping the row log-sum-exp the combine reads, over every column with
    pad 0; 3b over every row; 9 on the block extended by the 16-row halo
    (zeros at the ends of the sequence); PPEG on the grid. Each against its
    plain version on the same inputs at phase 3's bars."""
    import torch.nn.functional as F

    from mirror_tpu_torch.ops import conv1d, nystrom_attn, ppeg

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    side = math.isqrt(patches - 1) + 1  # ceil(sqrt(patches)), as wrap_pad_square
    n = -(-(1 + side * side) // M) * M
    halo = CONV_TAPS // 2
    q, k, v = randn(1, HEADS, n, DH, scale=DH ** -0.5), randn(1, HEADS, n, DH), \
        randn(1, HEADS, n, DH)
    q_l, k_l, w = randn(1, HEADS, M, DH, scale=DH ** -0.5), randn(1, HEADS, M, DH), \
        randn(1, HEADS, M, DH)
    v_ext = F.pad(v, (0, 0, halo, halo))
    kern = randn(HEADS, CONV_TAPS, scale=0.1)
    img = randn(1, side, side, EMBED)
    ppeg_k, ppeg_b = randn(7, 7, EMBED, scale=0.1), randn(EMBED, scale=0.1)
    conv_w = ppeg_k.permute(2, 0, 1).unsqueeze(1).clone()  # PPEG as one depthwise conv
    conv_w[:, 0, 3, 3] += 1
    attn_mma = 4 * HEADS * n * M * DH
    fmas = 2 * CONV_TAPS * v_ext.numel()
    return [
        Case("softmax_attn", "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:202",
             f"whole slide, kv with lse: r {M}, c {n}, pad 0, b 1, dh {DH}",
             lambda: nystrom_attn._launch_fwd(q_l, k, v, None, None, 0, keep=True)[:2],
             lambda: nystrom_attn.softmax_attn_fwd_ref(q_l, k, v)[:2],
             BOUND_SINGLE_ROUNDING, ("out", "lse"),
             dict(bytes=nbytes(q_l, k, v, q_l) + 4 * HEADS * M, mma=attn_mma),
             library=lambda: F.scaled_dot_product_attention(q_l, k, v, scale=1.0)),
        Case("softmax_attn_q", "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:208",
             f"whole slide, q: r {n}, c {M}, pad 0, b 1",
             lambda: nystrom_attn.softmax_matmul_landmark_q(q, k_l, w),
             lambda: nystrom_attn.softmax_attn_ref(q, k_l, w).to(bf16),
             BOUND_SINGLE_ROUNDING, ("out",),
             dict(bytes=nbytes(q, k_l, w, q), mma=attn_mma),
             library=lambda: F.scaled_dot_product_attention(q, k_l, w, scale=1.0)),
        Case("conv1d", "conv1d.cu", "mirror_tpu/ops/conv1d_pallas.py:258",
             f"whole slide, v with its halo {list(v_ext.shape)}, K {CONV_TAPS}, bf16 taps",
             lambda: conv1d.depthwise_conv1d_seq(v_ext, kern),
             lambda: conv1d.depthwise_conv_seq_ref(v_ext, kern).to(bf16),
             BOUND_SINGLE_ROUNDING, ("out",),
             dict(bytes=nbytes(v_ext, kern, v_ext), mma=fmas, fma_alt=fmas),
             library=lambda: F.conv2d(v_ext, kern.view(HEADS, 1, CONV_TAPS, 1),
                                      padding=(halo, 0), groups=HEADS)),
        Case("ppeg", "ppeg.cu", "mirror_tpu/ops/ppeg_pallas.py:179",
             f"whole slide [1, {side}, {side}, {EMBED}]",
             lambda: ppeg.ppeg_fused(img, ppeg_k, ppeg_b),
             lambda: ppeg.ppeg_ref(img, ppeg_k, ppeg_b), BOUND_SINGLE_ROUNDING, ("out",),
             dict(bytes=nbytes(img, ppeg_k, ppeg_b, img), mma=0,
                  fp32=(2 * 49 + 2) * img.numel()),
             library=lambda: F.conv2d(img.permute(0, 3, 1, 2), conv_w, ppeg_b, padding=3,
                                      groups=EMBED)),
    ]


def cp_group_check(torch, root: Path, ranks: int, backend: str, encoder_state, slide: Path,
                   want_seq, extra_cases=()):
    """``ranks`` processes of ``parallel/cp_worker.py`` over ``backend``
    (gloo: all on the one card; nccl: one a card): the whole-slide encoder
    on ``slide`` against ``want_seq`` (world 1), and one CP attention layer's
    output and gradient against world 1's at phase 5's bars (the ranks'
    gradients of 3c, 9b and 2b through the collectives), then
    ``extra_cases``. Returns rank 0's results."""
    from mirror_tpu_torch.parallel import worker

    from mirror_tpu_torch.models.nystrom import NystromAttention

    kwargs, attn, x, t = ws_attention(torch)
    want_out, want_gx, want_grads = cp_attention_here(torch, attn, x, t)
    # world 1's kernels against the plain path (use_pallas=False) on the card
    plain = NystromAttention(**dict(kwargs, use_pallas=False))
    plain.load_state_dict(attn.state_dict())
    plain_out, plain_gx, plain_grads = cp_attention_here(torch, plain.eval(), x, t)
    del plain
    out_rel, _ = seq_agreement(torch, want_out, plain_out)
    gx_cos = torch.nn.functional.cosine_similarity(want_gx.ravel(), plain_gx.ravel(),
                                                   dim=0).item()
    gx_ratio = (want_gx.norm() / plain_gx.norm()).item()
    worst, worst_leaf, worst_ratio = grad_agreement(want_grads, plain_grads)
    say(f"[whole_slide] one CP attention layer at world 1, the kernels (2, 2b, 3, 3b, 3c, 9, "
        f"9b) against the plain path (use_pallas=False) on the card: output relative error "
        f"{out_rel:.4g} (bound {BOUND_STEP_LOSS:g}); dL/dx cosine {gx_cos:.6f}, norm ratio "
        f"{gx_ratio:.5f}; parameters' gradients worst cosine {worst:.6f} ({worst_leaf}), "
        f"norm ratio furthest from 1 {worst_ratio:.5f} (bounds {BOUND_GRAD_COS}, "
        f"{BOUND_GRAD_NORM:g})")
    if not (out_rel <= BOUND_STEP_LOSS and gx_cos >= BOUND_GRAD_COS
            and abs(gx_ratio - 1) <= BOUND_GRAD_NORM and worst >= BOUND_GRAD_COS
            and abs(worst_ratio - 1) <= BOUND_GRAD_NORM):
        fail("[whole_slide] the CP gradient's kernels leave the plain path's bars")
    enc_kwargs = dict(input_dim=EMBED, embed_dim=EMBED, dtype=torch.bfloat16, dropout=0.0)
    cases = [dict(kind="encoder", kwargs=enc_kwargs, state_dict=encoder_state,
                  tokens_path=str(slide)),
             dict(kind="attention", kwargs=kwargs, state_dict=attn.state_dict(), x=x, t=t),
             *extra_cases]
    name = f"cp_{backend}_{ranks}"
    spec = root / f"{name}.spec.pt"
    torch.save(dict(device="cuda", cases=cases), spec)
    t0 = time.perf_counter()
    try:
        outs = worker.launch(spec, root / name, ranks, root / f"{name}.rdv", WS_TIMEOUT_S,
                             env={"MIRROR_DIST_BACKEND": backend, "OMP_NUM_THREADS": "4"},
                             module="mirror_tpu_torch.parallel.cp_worker")
    except RuntimeError as e:
        fail(f"[whole_slide] the ranks of {name} failed: {str(e)[-3000:]}")
    seconds = time.perf_counter() - t0
    enc, grad = outs[0]["results"][:2]
    rel, cos = seq_agreement(torch, enc["seq"], want_seq)
    say(f"[whole_slide] {name}: {ranks} processes over {backend}, the {slide.stem} slide "
        f"({want_seq.shape[0]} rows) encoded in {enc['ms']:.1f} ms (rank 0, host clock, the "
        f"ranks' first collectives in it{'; gloo through the host' if backend == 'gloo' else ''}"
        f"), peak {enc['peak_gib']:.2f} GiB a rank: against world "
        f"1 relative error {rel:.4g} (bound {BOUND_STEP_LOSS:g}), worst row cosine {cos:.6f} "
        f"(bound {BOUND_GRAD_COS}); launches {json.dumps(enc['launches'])}; the launch "
        f"{seconds:.1f} s")
    if not (rel <= BOUND_STEP_LOSS and cos >= BOUND_GRAD_COS):
        fail(f"[whole_slide] {name}: the encoded slide leaves world 1's bars")
    out_rel, _ = seq_agreement(torch, grad["out"], want_out)
    gx_cos = torch.nn.functional.cosine_similarity(grad["gx"].float().ravel(),
                                                   want_gx.ravel(), dim=0).item()
    gx_ratio = (grad["gx"].float().norm() / want_gx.norm()).item()
    worst, worst_leaf, worst_ratio = grad_agreement(grad["grads"], want_grads)
    for need in ("softmax_attn_bwd", "conv1d_bwd", PINV_BWD):
        if grad["launches"].get(need, 0) == 0:
            fail(f"[whole_slide] {name}: the CP gradient launched no {need}")
    say(f"[whole_slide] {name}: one CP attention layer ({WS_GRAD_N} rows, dim {EMBED}, "
        f"{HEADS} heads of {DH}, {M} landmarks, bf16, exact pinv gradient), sum(out t) "
        f"against world 1: output relative error {out_rel:.4g} (bound {BOUND_STEP_LOSS:g}); "
        f"dL/dx cosine {gx_cos:.6f}, norm ratio {gx_ratio:.5f}; parameters' gradients summed "
        f"over the ranks, worst cosine {worst:.6f} ({worst_leaf}), norm ratio furthest from "
        f"1 {worst_ratio:.5f} (bounds {BOUND_GRAD_COS}, {BOUND_GRAD_NORM:g}); rank 0's "
        f"launches {json.dumps(grad['launches'])}, {grad['ms']:.1f} ms")
    if not (out_rel <= BOUND_STEP_LOSS and gx_cos >= BOUND_GRAD_COS
            and abs(gx_ratio - 1) <= BOUND_GRAD_NORM and worst >= BOUND_GRAD_COS
            and abs(worst_ratio - 1) <= BOUND_GRAD_NORM):
        fail(f"[whole_slide] {name}: the CP gradient leaves world 1's bars")
    return outs[0]["results"]


def ws_classifier(torch, root: Path):
    """The subtyping template's classifier (phase 4's) with weights from
    SEED, saved as a .pth.tar; returns its path and its WSI encoder's state."""
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.checkpoint import save_checkpoint_file

    args = dict(model="mirror_classifier", model_kwargs=MODEL_KWARGS, num_classes=2,
                classes=list(CLASSES), num_wsi_feature_tokens=N_TOKENS, batch_size=WS_PREDICT,
                amp=True, amp_dtype="bfloat16", wsi_feature_only=False)
    model = create_model("mirror_classifier", device="cpu", num_classes=2,
                         generator=torch.Generator().manual_seed(SEED), **MODEL_KWARGS)
    ckpt = root / "ws_classifier.pth.tar"
    save_checkpoint_file(str(ckpt), model.state_dict(), args=args)
    state = {k[len("wsi_encoder."):]: v for k, v in model.state_dict().items()
             if k.startswith("wsi_encoder.")}
    return ckpt, state


def phase_whole_slide(torch, root: Path):
    """Whole-slide encoding (ROADMAP item 15; phase 10 in the docstring).
    Returns encode_slide's launches, the encode times and the results of
    :func:`ws_kernel_cases`."""
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch.data.formats import load_feature_file
    from mirror_tpu_torch.models.transmil import FeatureTransMIL
    from mirror_tpu_torch.ops import _common
    from mirror_tpu_torch.parallel.context_parallel import transmil_encode_cp, wrap_pad_square
    from mirror_tpu_torch.tools import encode_slide
    from mirror_tpu_torch.tools.predict import predict

    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    ckpt, state = ws_classifier(torch, root)
    feat_dir, pred_dir, rna_csv, ids = write_whole_slide_cohort(root)
    say(f"[whole_slide] set-up (the classifier's weights, {len(WS_SLIDES)} slides of "
        f"{', '.join(map(str, WS_SLIDES))} patches) {time.perf_counter() - t_phase:.1f} s")

    out_dir = root / "ws_embeddings"
    torch.cuda.synchronize()
    _common.reset_launch_counts()
    t0 = time.perf_counter()
    encode_slide.main(["--wsi-feature-dir", str(feat_dir), "--checkpoint", str(ckpt),
                       "--output", str(out_dir), "--save", "cls", "--dtype", "bfloat16"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _common.launch_counts()
    say(f"[whole_slide] encode_slide.main: {len(WS_SLIDES)} slides, every patch, in "
        f"{seconds:.2f} s (encoder build and file reads included); kernel launches "
        f"{json.dumps(launches)}")
    # per slide, two TransLayers (pinv, the kv attention, the q attention,
    # the conv each) and one PPEG; the pinv's GEMM 24 a pinv
    want = {"moore_penrose_pinv": 2, "softmax_attn": 2, "softmax_attn_q": 2, "conv1d": 2,
            "ppeg": 1, PINV_GEMM: 2 * 4 * PINV_ITERS}
    want = {k: v * len(WS_SLIDES) for k, v in want.items()}
    if launches != want:
        fail(f"[whole_slide] encode_slide's launches {launches}, expected {want}")
    embs = [np.load(out_dir / f"{sid}.npy") for sid in ids]
    if any(e.shape != (EMBED,) or not np.isfinite(e).all() for e in embs):
        fail("[whole_slide] an embedding is not a finite [768] vector")

    # world 1: each slide's encode timed, its peak memory; the outputs kept
    encoder = encode_slide.build_encoder(state, torch.bfloat16, True, torch.device("cuda"))
    seqs, rows = {}, []
    with torch.no_grad():
        for sid, n in zip(ids, WS_SLIDES):
            feats = np.asarray(load_feature_file(str(feat_dir / f"{sid}.npy")), np.float32)
            tokens = torch.from_numpy(np.array(wrap_pad_square(feats))).cuda()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            seqs[n] = transmil_encode_cp(encoder, tokens).float().cpu()
            peak = torch.cuda.max_memory_allocated() / 2**30
            times = []
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                transmil_encode_cp(encoder, tokens)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            rows.append(dict(patches=n, rows=seqs[n].shape[0], ms=ms, peak_gib=peak))
            say(f"[whole_slide] {n} patches ({seqs[n].shape[0]} rows after the wrap pad and "
                f"cls): encode {ms:.3f} ms (median of 3, CUDA events, world 1), "
                f"{n / ms * 1e3:.0f} patches/s, peak device memory {peak:.2f} GiB; on {smi}")
    if not all(torch.isfinite(s).all() for s in seqs.values()):
        fail("[whole_slide] an encoded sequence is not finite")

    # the gloo pair on the one card: the 100,000 slide and the CP gradient,
    # and predict (--whole-slide, and the token subsample) in 2 ranks
    predict_argv = ["--checkpoint", str(ckpt), "--task", "subtyping", "--wsi-feature-dir",
                    str(pred_dir), "--rna-feature-csv", str(rna_csv), "--batch-size",
                    str(WS_PREDICT), "--seed", str(SEED)]
    extra = [dict(kind="main", module="mirror_tpu_torch.tools.predict",
                  argv=predict_argv + ["--whole-slide", "--output", str(root / "ws_2.csv")]),
             dict(kind="main", module="mirror_tpu_torch.tools.predict",
                  argv=predict_argv + ["--output", str(root / "pred_2.csv")])]
    big = feat_dir / f"{ids[-1]}.npy"

    # world 1 against the module's kernel path (40,000) and the CPU (15,000)
    def module_encode(device, dtype, n):
        with torch.device("meta"):
            enc = FeatureTransMIL(EMBED, EMBED, dtype, dropout=0.0)
        enc = enc.to_empty(device=device).eval()
        enc.load_state_dict(state)
        feats = np.asarray(load_feature_file(str(feat_dir / f"{ids[WS_SLIDES.index(n)]}.npy")),
                           np.float32)
        with torch.no_grad():
            return enc.encode(torch.from_numpy(feats)[None].to(device))[0][0].float().cpu()

    for n, device, dtype, bound, what in (
            (40_000, "cuda", torch.bfloat16, BOUND_STEP_LOSS,
             "FeatureTransMIL.encode's kernel path on the card (bf16)"),
            (15_000, "cpu", None, BOUND_LOGITS, "the CPU's plain path (fp32)")):
        t0 = time.perf_counter()
        rel, cos = seq_agreement(torch, seqs[n], module_encode(device, dtype, n))
        say(f"[whole_slide] world 1 on the {n}-patch slide against {what}: relative error "
            f"{rel:.4g} (bound {bound:g}), worst row cosine {cos:.6f} (bound "
            f"{BOUND_GRAD_COS}); {time.perf_counter() - t0:.1f} s")
        if not (rel <= bound and cos >= BOUND_GRAD_COS):
            fail(f"[whole_slide] world 1 on the {n}-patch slide leaves the bars")
    torch.cuda.empty_cache()

    # kernels 3, 3b, 9 and 5 at the 100,000-patch slide's shapes
    ws_kernels = [run_case(torch, case) for case in ws_kernel_cases(torch, WS_SLIDES[-1])]
    torch.cuda.empty_cache()

    for whole, csv in ((True, "ws_1.csv"), (False, "pred_1.csv")):
        predict(str(ckpt), "subtyping", str(pred_dir), str(root / csv),
                rna_feature_csv=str(rna_csv), batch_size=WS_PREDICT, seed=SEED,
                whole_slide=whole)
    del encoder
    torch.cuda.empty_cache()
    cp_group_check(torch, root, 2, "gloo", state, big, seqs[WS_SLIDES[-1]], extra)
    for one, two, what in (("ws_1.csv", "ws_2.csv", "predict --whole-slide"),
                           ("pred_1.csv", "pred_2.csv", "predict")):
        a, b = pd.read_csv(root / one), pd.read_csv(root / two)
        cols = [c for c in a.columns if c.startswith("prob_")]
        diff = float(np.abs(a[cols].to_numpy() - b[cols].to_numpy()).max())
        say(f"[whole_slide] {what} in 2 gloo ranks against one process, {len(a)} slides: "
            f"probabilities {b[cols].to_numpy().round(6).tolist()} vs "
            f"{a[cols].to_numpy().round(6).tolist()}, max |difference| {diff:.3g} (bound "
            f"{BOUND_LOGITS:g})")
        if list(a["slide_id"]) != list(b["slide_id"]) or not diff <= BOUND_LOGITS:
            fail(f"[whole_slide] {what} in 2 ranks leaves one process's bar")
    say(f"[whole_slide] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, rows, ws_kernels


def phase_cp_cards(torch, ranks: int) -> None:
    """``chip_smoke.py --cp-ranks R`` on R cards of one host: the kernels
    built, the 100,000-patch slide written, and :func:`cp_group_check` with
    one process a card over NCCL."""
    import numpy as np

    from mirror_tpu_torch.data.formats import load_feature_file
    from mirror_tpu_torch.parallel.context_parallel import transmil_encode_cp, wrap_pad_square
    from mirror_tpu_torch.tools import encode_slide

    if torch.cuda.device_count() < ranks:
        fail(f"--cp-ranks {ranks}: {torch.cuda.device_count()} card(s)")
    phase_build()
    build_root = REPO / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        _, state = ws_classifier(torch, root)
        feat_dir, _, _, ids = write_whole_slide_cohort(root)
        big = feat_dir / f"{ids[-1]}.npy"
        encoder = encode_slide.build_encoder(state, torch.bfloat16, True, torch.device("cuda"))
        feats = np.asarray(load_feature_file(str(big)), np.float32)
        with torch.no_grad():
            want = transmil_encode_cp(encoder, torch.from_numpy(np.array(
                wrap_pad_square(feats))).cuda()).float().cpu()
        del encoder
        torch.cuda.empty_cache()
        cp_group_check(torch, root, ranks, "nccl", state, big, want)


# the tools (phase 11): the exported programs' batch and its two slides
# (tiled: the pinv's scale is a maximum over the batch, so the 2-slide CPU
# reference sees the scale the 16-slide program does), their timed runs, the
# fresh process's time limit; the fold drivers' 2 folds of 16 train and 16
# validation slides (one step a fold), two jobs at once on the one card
EXPORT_REF_SLIDES, EXPORT_REPS, EXPORT_TIMEOUT = 2, 5, 600
LAUNCH_FOLDS, LAUNCH_TRAIN, LAUNCH_VAL, LAUNCH_TIMEOUT = 2, 16, 16, 600
# a flax msgpack checkpoint, as flax.serialization.msgpack_serialize wrote it:
# {"arch": "mirror_classifier", "args": "", "ema_state_dict": {}, "epoch": 1,
#  "metric": -1.0, "opt_state": None, "state_dict": {"head": {"bias": bf16
#  [0.5, -1, 2], "kernel": float32 arange(6) as [2, 3]}}, "version": 2}
FLAX_BLOB = bytes.fromhex(
    "88a461726368b16d6972726f725f636c6173736966696572a461726773a0ae656d615f73746174655f64"
    "69637480a565706f636801a66d6574726963cbbff0000000000000a96f70745f7374617465c0aa737461"
    "74655f6469637481a46865616482a462696173c71401939103a862666c6f61743136c406003f80bf0040"
    "a66b65726e656cc7260193920203a7666c6f61743332c418000000000000803f0000004000004040000080"
    "400000a040a776657273696f6e02")
# run by a fresh process: the .pt2 programs loaded with the ops module alone
# (no model code), each run once on the card with the launch counts set to 0
# just before and read just after, then timed; outputs and counts written out
EXPORTED_RUN = r"""
import json, statistics, sys, time
import torch
from mirror_tpu_torch.ops import _common
root, reps, names = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
wsi, rna = (t.cuda() for t in torch.load(f"{root}/inputs.pt"))
report = {}
for name in names:
    t0 = time.perf_counter()
    program = torch.export.load(f"{root}/{name}.pt2").module()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        torch.cuda.synchronize()
        _common.reset_launch_counts()
        out = program(wsi, rna)
        torch.cuda.synchronize()
        launches = _common.launch_counts()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            program(wsi, rna)
            torch.cuda.synchronize()
            times.append(1000 * (time.perf_counter() - t0))
    out = out if isinstance(out, tuple) else (out,)
    torch.save([o.float().cpu() for o in out], f"{root}/{name}.out.pt")
    report[name] = {"load_s": load_s, "launches": launches, "ms": statistics.median(times)}
report["model_code_imported"] = "mirror_tpu_torch.models" in sys.modules
print(json.dumps(report))
"""


def export_inputs(torch):
    """The exported programs' batch of 16: 2 slides of random features and
    RNA from SEED, tiled 8 times."""
    g = torch.Generator().manual_seed(SEED + 11)
    wsi = torch.randn(EXPORT_REF_SLIDES, N_TOKENS, 768, generator=g)
    rna = torch.randn(EXPORT_REF_SLIDES, RNA_DIM, generator=g)
    tiles = B // EXPORT_REF_SLIDES
    return wsi.repeat(tiles, 1, 1), rna.repeat(tiles, 1)


def check_exports(torch, root: Path, exports: dict, wsi, rna):
    """The programs run by a fresh process against the eager modules on the
    card and the CPU's plain path on the batch's 2 slides; returns the
    exported runs' launch counts, summed."""
    from mirror_tpu_torch.tools.export_model import build_inference_module

    torch.save([wsi, rna], root / "inputs.pt")
    proc = subprocess.run([sys.executable, "-c", EXPORTED_RUN, str(root), str(EXPORT_REPS),
                           *exports], cwd=REPO, capture_output=True, text=True,
                          timeout=EXPORT_TIMEOUT)
    if proc.returncode != 0:
        fail(f"[export] the fresh process failed:\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    if report["model_code_imported"]:
        fail("[export] loading the programs imported the model code")
    wsi_d, rna_d = wsi.cuda(), rna.cuda()  # resident, as in the fresh process
    launches = {}
    for name, (mode, ckpt, model) in exports.items():
        got = torch.load(root / f"{name}.out.pt")
        run = report[name]
        missing = [k for k in FORWARD if run["launches"].get(k, 0) == 0]
        if missing:
            fail(f"[export] the {name} program never launched {missing}: {run['launches']}")
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        module = build_inference_module(mode, model, str(ckpt), {}, torch.device("cuda"))
        with torch.no_grad():
            eager = module(wsi_d, rna_d)
            eager = [o.float().cpu() for o in (eager if isinstance(eager, tuple) else (eager,))]
            times = []
            for _ in range(EXPORT_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                module(wsi_d, rna_d)
                torch.cuda.synchronize()
                times.append(1000 * (time.perf_counter() - t0))
        del module
        torch.cuda.empty_cache()
        same = all(torch.equal(a, b) for a, b in zip(got, eager))
        diff = max((a - b).abs().max().item() for a, b in zip(got, eager))
        rel = max(rel_err(a, b) for a, b in zip(got, eager))
        say(f"[export] {name}: loaded in a fresh process (ops module only) in "
            f"{run['load_s']:.2f} s; one batch of {B} launched {json.dumps(run['launches'])}; "
            f"{run['ms']:.3f} ms a batch exported vs {statistics.median(times):.3f} ms eager "
            f"(median of {EXPORT_REPS}, host clock, inputs resident); against the eager module "
            f"on the card: {'bit for bit' if same else 'not bit for bit'}, max abs "
            f"difference {diff:.4g}, relative {rel:.4g}")
        if not same:
            fail(f"[export] {name}: the program and the eager module disagree")
        cpu = build_inference_module(mode, model, str(ckpt), {}, torch.device("cpu"))
        with torch.no_grad():
            ref = cpu(wsi[:EXPORT_REF_SLIDES], rna[:EXPORT_REF_SLIDES])
        ref = ref if isinstance(ref, tuple) else (ref,)
        rels = [rel_err(a[:EXPORT_REF_SLIDES], b) for a, b in zip(got, ref)]
        say(f"[export] {name}: {EXPORT_REF_SLIDES} slides, the card's program vs the CPU's "
            f"plain path (bf16): relative errors {[f'{r:.4g}' for r in rels]} (bound "
            f"{BOUND_LOGITS:g})")
        if not all(torch.isfinite(a).all() for a in got) or max(rels) > BOUND_LOGITS:
            fail(f"[export] {name}: the program disagrees with the CPU reference")
    return launches


def dispatch_cost(torch):
    """Host µs a call of a mirror:: op costs beyond a direct call of its
    CUDA implementation (the same launch and count, no dispatcher), at
    shapes whose device time is short, in turns direct, op, op, direct."""
    from mirror_tpu_torch.ops import landmark, ppeg

    g = torch.Generator(device="cuda").manual_seed(SEED)
    img = torch.randn(1, 8, 8, 64, device="cuda", generator=g).to(torch.bfloat16)
    kern = torch.randn(7, 7, 64, device="cuda", generator=g).to(torch.bfloat16)
    bias = torch.randn(64, device="cuda", generator=g).to(torch.bfloat16)
    q, k = (torch.randn(1, 1, 64, 64, device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(2))
    cases = {"ppeg": (ppeg._ppeg_cuda, ppeg.ppeg_op, (img, kern, bias)),
             "landmark_softmax": (landmark._landmark_softmax_cuda, landmark.landmark_softmax_op,
                                  (q, k, 8, 0))}
    calls, out = 2000, {}
    for name, (direct, op, args) in cases.items():
        per_call = {"direct": [], "op": []}
        for which in ("direct", "op", "op", "direct"):
            fn = direct if which == "direct" else op
            for _ in range(50):
                fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
            per_call[which].append(1e6 * (time.perf_counter() - t0) / calls)
        d, o = statistics.mean(per_call["direct"]), statistics.mean(per_call["op"])
        out[name] = o - d
        say(f"[dispatch] {name}: {o:.2f} µs a call through the op, {d:.2f} µs a direct call "
            f"of its CUDA implementation (means of 2 runs of {calls}, in turns): the dispatch "
            f"costs {o - d:.2f} µs a call on the host; readings {json.dumps(per_call)}")
    return out


def two_fold_splits(features: Path, split_dir: Path, train: int, val: int) -> None:
    """splits_0.csv and splits_1.csv over the cohort's first slides: each
    fold ``train`` patients to train and ``val`` to validate, the two folds
    swapped."""
    import pandas as pd

    patients = sorted(f.name[:12] for f in features.rglob("*.npy"))[:train + val]
    split_dir.mkdir(parents=True)
    for fold, (tr, va) in enumerate(((patients[:train], patients[train:]),
                                     (patients[val:], patients[:val]))):
        pd.DataFrame({"train": pd.Series(tr), "val": pd.Series(va)}).to_csv(
            split_dir / f"splits_{fold}.csv")


def run_driver(tag: str, argv) -> str:
    """A fold driver in its own process, without a MIRROR_PLATFORM of this
    process's environment; fails on a non-zero exit or on a job whose model
    was not built on the card (the CLIs' "Model ... created on" log line).
    Prints the slot and environment (CUDA_VISIBLE_DEVICES) each job was
    given, from the launcher's log, the jobs' devices and the --result
    count; returns its standard output."""
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "MIRROR_PLATFORM"}
    proc = subprocess.run([sys.executable, "-m", f"mirror_tpu_torch.tools.{tag}", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT,
                          env=env)
    pinned = [ln.split("launcher:")[-1].split(": ")[0] for ln in proc.stderr.splitlines()
              if "launcher:job" in ln and "starting on slot" in ln]
    devices = re.findall(r"Model \S+ created on (\S+),", proc.stderr)
    say(f"[{tag}] exit code {proc.returncode} in {time.perf_counter() - t0:.1f} s; "
        f"{proc.stdout.count('--result')} --result blocks; jobs: {pinned}; the jobs' models "
        f"created on {devices}")
    if proc.returncode != 0 or len(pinned) != LAUNCH_FOLDS or len(devices) != LAUNCH_FOLDS \
            or any(not d.startswith("cuda") for d in devices):
        fail(f"[{tag}] failed:\n{proc.stderr[-4000:]}")
    return proc.stdout


def write_job_yaml(path: Path, template: Path, **keys) -> str:
    import yaml

    cfg = yaml.safe_load(template.read_text())
    cfg.update(keys)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def phase_tools(torch, root: Path, pretrain_root: Path, down_root: Path):
    """The tools (ROADMAP item 17; phase 11 in the docstring): the exports
    of phase 7's subtyping checkpoint (classifier) and phase 5's pretrain
    checkpoint (embed) at batch 16, run by a fresh process with the ops
    module alone; the op dispatch's host cost; split_weights;
    import_jax_checkpoint's chain; the two fold drivers on slot 0. Returns
    the exported runs' launches (the ``export`` path)."""
    import importlib.util

    from mirror_tpu_torch.tools import export_model, split_weights
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file

    t_phase = time.perf_counter()
    root.mkdir(parents=True)
    pre_ckpt = pretrain_root / "runs" / "pretrain" / "smoke" / "last.pth.tar"
    sub_ckpt = down_root / "runs" / "subtyping" / "subtyping" / "last.pth.tar"
    exports = {"classifier": ("classifier", sub_ckpt, "mirror_classifier"),
               "embed": ("embed", pre_ckpt, "mirror")}
    for name, (mode, ckpt, model) in exports.items():
        t0 = time.perf_counter()
        manifest = export_model.export_model(mode, model, str(ckpt), str(root / f"{name}.pt2"),
                                             B, N_TOKENS, 768, RNA_DIM, {}, device="cuda")
        seconds = time.perf_counter() - t0
        if sorted(manifest["ops"]) != sorted(f"mirror::{op}" for op in (
                "landmark_softmax", "pinv", "softmax_attn", "softmax_attn_conv", "ppeg")):
            fail(f"[export] {name}: the graph calls {manifest['ops']}")
        say(f"[export] {name} ({model}, {ckpt.name}): exported on the card in {seconds:.1f} s "
            f"(model build, load and trace), {manifest['bytes']} bytes, ops {manifest['ops']}")
    wsi, rna = export_inputs(torch)
    launches = check_exports(torch, root, exports, wsi, rna)
    dispatch = dispatch_cost(torch)

    paths = split_weights.split_weights(str(pre_ckpt), str(root))
    for modality, path in zip(("wsi", "rna"), paths):
        keys = list(load_checkpoint_file(path)["state_dict"])
        if not keys or any(not k.startswith(f"{modality}_encoder.") for k in keys) \
                or f"{modality}_encoder.mask_token" in keys:
            fail(f"[split] {path}: keys {keys[:5]}...")
        say(f"[split] {Path(path).name}: {len(keys)} tensors, every key under "
            f"{modality}_encoder., no mask_token")

    (root / "jax.msgpack").write_bytes(FLAX_BLOB)
    others = ("jax", "flax", "msgpack", "ml_dtypes")
    proc = subprocess.run(
        [sys.executable, "-m", "mirror_tpu_torch.tools.import_jax_checkpoint", "--checkpoint",
         str(root / "jax.msgpack"), "--output", str(root / "jax.pth.tar")], cwd=REPO,
        capture_output=True, text=True, timeout=EXPORT_TIMEOUT,
        env=dict(os.environ, PYTHONVERBOSE="1"))
    imported = sorted({m for m in others for ln in proc.stderr.splitlines()
                       if ln.startswith(f"import '{m}'")})
    if proc.returncode != 0 or imported:
        fail(f"[import] exit code {proc.returncode}, imported {imported}:\n"
             f"{proc.stderr[-2000:]}")
    state = load_checkpoint_file(str(root / "jax.pth.tar"))["state_dict"]
    if not torch.equal(state["head.weight"], torch.arange(6.0).reshape(2, 3).T) or \
            not torch.equal(state["head.bias"], torch.tensor([0.5, -1.0, 2.0])):
        fail(f"[import] decoded {state}")
    has = [m for m in others if importlib.util.find_spec(m) is not None]
    say(f"[import] python -m mirror_tpu_torch.tools.import_jax_checkpoint read a file flax "
        f"wrote, in a process of its own (head.weight the kernel's transpose, the bf16 bias "
        f"as float32); of {list(others)} this machine has {has}, and that process imported "
        f"none")

    # the fold drivers, slot 0: k 2 folds of train_mirror (the pretrain
    # template) on phase 5's cohort, then the evaluator's subtyping runs
    # (the subtyping template) on phase 7's, warm-started from each fold
    feats = pretrain_root / "features"
    two_fold_splits(feats, root / "pre_splits", LAUNCH_TRAIN, LAUNCH_VAL)
    runs = root / "runs"
    common = dict(epochs=1, batch_size=B, k=LAUNCH_FOLDS, output=str(runs), log_interval=1,
                  seed=SEED, workers=8)
    pre_yaml = write_job_yaml(root / "pre.yaml", PRETRAIN_YAML, wsi_feature_dir=str(feats),
                              rna_feature_csv=str(pretrain_root / "rna.csv"),
                              split_dir=str(root / "pre_splits"), **common)
    run_driver("pretrain_job_launcher", ["--config", pre_yaml, "--k", str(LAUNCH_FOLDS),
                                         "--slots", "0", "--virtual-factor", "2",
                                         "--output-root", str(runs)])
    two_fold_splits(down_root / "features", root / "down_splits", LAUNCH_TRAIN, LAUNCH_VAL)
    sub_yaml = write_job_yaml(root / "sub.yaml", SUBTYPING_YAML,
                              wsi_feature_dir=str(down_root / "classes"),
                              rna_feature_csv=str(down_root / "rna.csv"),
                              split_dir=str(root / "down_splits"), classes=list(CLASSES),
                              **common)
    out = run_driver("downstream_tasks_evaluator",
                     ["--pretrain-root", str(runs / "pretrain"), "--task-configs",
                      f"subtyping:{sub_yaml}", "--k", str(LAUNCH_FOLDS), "--slots", "0",
                      "--virtual-factor", "2"])
    if out.count("--result") != LAUNCH_FOLDS:
        fail(f"[downstream_tasks_evaluator] {out.count('--result')} results")
    say(f"[tools] phase {time.perf_counter() - t_phase:.1f} s")
    return launches, dispatch


# ---- Phase 12: the float32 and float16 instances (--no-amp, --amp-dtype float16) ----

INSTANCE_DTYPES = ("float32", "float16")
# the bars of an instance against its plain version in its own type
# (mirror_tpu_torch/scripts/_timing.py says why): float32 BOUND_F32 forward,
# BOUND_F32_BWD backward and for the pinv; float16 bf16's bars
INSTANCE_BARS = {"float32": dict(fwd=BOUND_F32, bwd=BOUND_F32_BWD, pinv=BOUND_F32_BWD,
                                 pinv_bwd=BOUND_F32_BWD),
                 "float16": dict(fwd=BOUND_SINGLE_ROUNDING, bwd=BOUND_BWD, pinv=BOUND_PINV,
                                 pinv_bwd=BOUND_PINV_BWD)}
INSTANCE_BARS["bfloat16"] = INSTANCE_BARS["float16"]  # phase 13's bf16 rows: phase 3's bars
# One train step at batch 2, the card's kernels in the type against the
# CPU's float32 plain path, same weights and draws: (loss relative error,
# gradient cosine, gradient norm ratio). float32 rounds nowhere but the
# 3xTF32 products (about 2^-21 relative) and the sums' orders, so 1e-4, a
# cosine of 0.9999 and norms within 1e-3; float16 rounds where bf16 does,
# with a finer ulp: phase 5's bf16 bars.
INSTANCE_STEP_BARS = {"float32": (1e-4, 0.9999, 1e-3),
                      "float16": (2e-2, 0.99, 5e-2)}
# Two slides scored by predict's model on the card in the type against the
# CPU's float32 plain path: relative error of the logits within 1e-3
# (float32: 3xTF32 products through two Nystrom layers and their 6-step
# pinvs) or phase 4's 5e-2 (float16, as bf16).
INSTANCE_LOGITS = {"float32": 1e-3, "float16": BOUND_LOGITS}
# the whole slides predict --whole-slide scores in each type (patches)
INSTANCE_WS_SLIDES = (3000, 9000)
# The bf16 instances' outputs at the train slice's shapes (bf16_outputs,
# seeded inputs), sha256 of their bytes, first 16 hex digits: those of the
# tree before the float32 and float16 instances were added, read on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6). The bf16 instances must
# keep those bits.
BF16_DIGESTS = {
    "landmark_softmax": "34ff9a41a41da902", "landmark_softmax_bwd": "355c8d6dc0bc859e",
    "moore_penrose_pinv": "96ba3d40ada30365", "moore_penrose_pinv_bwd": "eca759e0b4cb58c5",
    "softmax_attn": "72a2d7fc39d08189", "softmax_attn_q": "9b5101e8cf9ee21e",
    "softmax_attn_conv": "585223618733feef", "softmax_attn_bwd": "8f0847c14b077a1e",
    "softmax_attn_conv_bwd": "e8a858c908f78585", "ppeg": "879035f57bc475c2",
    "ppeg_bwd": "7fe20147b1fabf2a", "conv1d": "07347f294b56f1a1",
    "conv1d_bwd": "c71411e422249180"}


def instance_cases(torch, randn, dtype, embed=EMBED, backward=True):
    """Kernels 1-5 and 9 with (``backward``) their backwards, the ``dtype``
    instance, at the shapes of a model of width ``embed`` (8 heads of embed
    / 8, embed / 2 landmarks; the train slice's by default: the encoder's
    2117 rows with pad 187, b 16, dh 96, 384 landmarks; the pinv at [16, 8,
    384, 384]; PPEG on [16, 46, 46, 768]; the conv on [16, 8, 2117, 96]),
    each against its plain version in the same type and the PyTorch call for
    the same function in that type."""
    import torch.nn.functional as F

    from mirror_tpu_torch.ops import conv1d, landmark, nystrom_attn, pinv, ppeg
    from mirror_tpu_torch.ops._common import instance

    dn = str(dtype).split(".")[-1]
    bars, peak = INSTANCE_BARS[dn], PEAK_MMA_FLOPS[dtype]
    b, n, dh, m = B, N, embed // HEADS, embed // 2
    pad = (m - n % m) % m
    bh = b * HEADS
    width = "" if embed == EMBED else f"embed {embed}: "
    shape = f"{width}b {b}, h {HEADS}, n {n}, pad {pad}, dh {dh}, m {m}, {dn}"

    def r(*s, scale=1.0):
        return randn(*s, scale=scale, dtype=dtype)

    def name(kernel):
        return instance(kernel, dtype)

    q = r(b, HEADS, n, dh, scale=dh ** -0.5)
    k, v = r(b, HEADS, n, dh), r(b, HEADS, n, dh)
    q_l, k_l, attn2, lse = landmark.landmark_softmax_lse_ref(q, k, m, pad)
    w = r(b, HEADS, m, dh)
    kern = r(HEADS, CONV_TAPS, scale=CONV_TAPS ** -0.5)
    attn_mma = 4 * bh * n * m * dh
    conv_mma = 2 * bh * n * dh * CONV_TAPS
    k_pad = torch.cat([k.new_zeros(b, HEADS, pad, dh), k], dim=2)
    v_pad = torch.cat([v.new_zeros(b, HEADS, pad, dh), v], dim=2)
    x = torch.softmax(randn(b, HEADS, m, m).float(), -1).to(dtype)
    s = pinv.global_scale(x)
    img = r(b, SIDE, SIDE, embed)
    pk, pb = r(7, 7, embed, scale=0.1), r(embed, scale=0.1)
    conv_w = pk.permute(2, 0, 1).unsqueeze(1).clone()
    conv_w[:, 0, 3, 3] += 1
    img_nchw = img.permute(0, 3, 1, 2)
    weight = kern.view(HEADS, 1, CONV_TAPS, 1)
    pshape = f"{width}b {b}, h {HEADS}, m {m}, {dn}"
    cshape = f"[{b}, {SIDE}, {SIDE}, {embed}], {dn}"
    vshape = f"v [{b}, {HEADS}, {n}, {dh}], K {CONV_TAPS}, {dn}"
    fmas = 2 * CONV_TAPS * v.numel()

    def pinv_check(z, z_ref):
        eye = torch.eye(m, device=x.device)
        err = (x.float() @ z.float() - eye).abs().max().item()
        err_ref = (x.float() @ z_ref.float() - eye).abs().max().item()
        say(f"[instance] {name('moore_penrose_pinv')} (m {m}): |x z - I| max {err:.4g} "
            f"(plain {err_ref:.4g})")
        return err <= max(1.5 * err_ref, 0.05)

    cases = [
        Case(name("landmark_softmax"), "landmark.cu", "mirror_tpu/ops/landmark_pallas.py:183",
             shape, lambda: landmark._launch_fwd(q, k, m, pad),
             lambda: landmark.landmark_softmax_lse_ref(q, k, m, pad), bars["fwd"],
             ("q_l", "k_l", "attn2", "lse"),
             dict(bytes=nbytes(q, k, q_l, k_l, attn2, lse), mma=2 * bh * m * m * dh,
                  mma_peak=peak)),
        Case(name("softmax_attn"), "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:202",
             f"{width}kv: r {m}, c {n}, pad {pad}, b {b}, dh {dh}, {dn}",
             lambda: nystrom_attn.softmax_matmul_landmark_kv(q_l, k, v, pad),
             lambda: nystrom_attn.softmax_attn_ref(q_l, k, v, pad).to(dtype), bars["fwd"],
             ("out",), dict(bytes=nbytes(q_l, k, v, q_l), mma=attn_mma, mma_peak=peak),
             library=lambda: F.scaled_dot_product_attention(q_l, k_pad, v_pad, scale=1.0)),
        Case(name("softmax_attn_q"), "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:208",
             f"{width}q: r {n}, c {m}, pad 0, {dn}",
             lambda: nystrom_attn.softmax_matmul_landmark_q(q, k_l, w),
             lambda: nystrom_attn.softmax_attn_ref(q, k_l, w).to(dtype), bars["fwd"], ("out",),
             dict(bytes=nbytes(q, k_l, w, q), mma=attn_mma, mma_peak=peak),
             library=lambda: F.scaled_dot_product_attention(q, k_l, w, scale=1.0)),
        Case(name("softmax_attn_conv"), "softmax_attn.cu",
             "mirror_tpu/ops/nystrom_pallas.py:354", shape,
             lambda: nystrom_attn.fused_softmax_attn_conv(q, k_l, w, v, kern),
             lambda: (nystrom_attn.softmax_attn_ref(q, k_l, w)
                      + nystrom_attn.depthwise_conv_seq_ref(v, kern)).to(dtype),
             bars["fwd"], ("out",),
             dict(bytes=nbytes(q, k_l, w, v, kern, q), mma=attn_mma + conv_mma, mma_peak=peak)),
        Case(name("moore_penrose_pinv"), "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:239", pshape,
             lambda: pinv.moore_penrose_pinv(x), lambda: pinv.pinv_iterations_ref(x, s),
             bars["pinv"], ("z",),
             dict(bytes=2 * nbytes(x), mma=6 * 4 * 2 * bh * m ** 3, mma_peak=peak),
             check=pinv_check, library=lambda: pinv_library(torch, x, s, PINV_ITERS)),
        Case(name("ppeg"), "ppeg.cu", "mirror_tpu/ops/ppeg_pallas.py:179", cshape,
             lambda: ppeg.ppeg_fused(img, pk, pb), lambda: ppeg.ppeg_ref(img, pk, pb),
             bars["fwd"], ("out",),
             dict(bytes=nbytes(img, pk, pb, img), mma=0, fp32=(2 * 49 + 2) * img.numel()),
             library=lambda: F.conv2d(img_nchw, conv_w, pb, padding=3, groups=embed)),
        Case(name("conv1d"), "conv1d.cu", "mirror_tpu/ops/conv1d_pallas.py:258", vshape,
             lambda: conv1d.depthwise_conv1d_seq(v, kern),
             lambda: conv1d.depthwise_conv_seq_ref(v, kern).to(dtype), bars["fwd"], ("out",),
             dict(bytes=nbytes(v, kern, v), mma=fmas, mma_peak=peak),
             library=lambda: F.conv2d(v, weight, padding=(CONV_TAPS // 2, 0), groups=HEADS)),
    ]
    if not backward:
        return cases

    gql, gkl, ga2 = r(b, HEADS, m, dh), r(b, HEADS, m, dh), r(b, HEADS, m, m)
    g2, g3, g4 = r(b, HEADS, m, m), r(b, HEADS, m, dh), r(b, HEADS, n, dh)
    g5 = r(b, SIDE, SIDE, embed)
    g5_nchw = g5.permute(0, 3, 1, 2)
    dv, dkern = torch.empty_like(v), torch.empty(HEADS, CONV_TAPS, device=v.device)
    partial = conv1d.conv1d_bwd_scratch(v, CONV_TAPS)

    def bwd9():
        conv1d.conv1d_bwd_into(v, kern, g4, dv, dkern, partial)
        return dv, dkern

    return cases + [
        Case(name("landmark_softmax_bwd"), "landmark_bwd.cu",
             "mirror_tpu/ops/landmark_pallas.py:148", shape,
             lambda: landmark._launch_bwd(q_l, k_l, lse, n, pad, gql, gkl, ga2),
             lambda: landmark.landmark_softmax_bwd_lse_ref(q_l, k_l, lse, n, pad, gql, gkl,
                                                           ga2),
             bars["bwd"], ("dq", "dk"),
             dict(bytes=nbytes(q_l, k_l, lse, gql, gkl, ga2, q, k), mma=3 * 2 * bh * m * m * dh,
                  mma_peak=peak)),
        Case(name("softmax_attn_bwd"), "softmax_attn_bwd.cu",
             "mirror_tpu/ops/nystrom_pallas.py:152",
             f"{width}kv: r {m}, c {n}, pad {pad}, b {b}, dh {dh}, {dn}",
             autograd_kernel(torch, lambda a, b_, c: nystrom_attn.softmax_matmul_landmark_kv(
                 a, b_, c, pad), (q_l, k, v), (g3,)),
             lambda: nystrom_attn.softmax_attn_bwd_ref(q_l, k, v, g3, pad), bars["bwd"],
             ("dq_l", "dk", "dv"),
             dict(bytes=2 * nbytes(q_l, k, v) + nbytes(g3), mma=5 * 2 * bh * m * n * dh,
                  mma_peak=peak),
             library=autograd_kernel(
                 torch, lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, scale=1.0),
                 (q_l, k_pad, v_pad), (g3,))),
        Case(name("softmax_attn_conv_bwd"), ("softmax_attn_bwd.cu", "conv1d.cu"),
             "mirror_tpu/ops/nystrom_pallas.py:318", shape,
             autograd_kernel(torch, nystrom_attn.fused_softmax_attn_conv, (q, k_l, w, v, kern),
                             (g4,)),
             lambda: (*nystrom_attn.softmax_attn_bwd_ref(q, k_l, w, g4),
                      *nystrom_attn.depthwise_conv_seq_bwd_ref(v, kern, g4)),
             bars["bwd"], ("dq", "dk_l", "dw", "dv", "dkern"),
             dict(bytes=2 * nbytes(q, k_l, w, v, kern) + nbytes(g4),
                  mma=5 * 2 * bh * n * m * dh + 2 * conv_mma, mma_peak=peak)),
        Case(name(PINV_BWD), "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:171", pshape,
             lambda: pinv._pinv_exact_bwd_kernel(x, s, g2, PINV_ITERS),
             lambda: pinv.pinv_exact_bwd_ref(x, s, g2, PINV_ITERS), bars["pinv_bwd"],
             ("gx", "gs"),
             dict(bytes=3 * nbytes(x) + nbytes(s), mma=(12 * PINV_ITERS - 1) * 2 * bh * m ** 3,
                  mma_peak=peak),
             library=lambda: pinv_bwd_library(torch, x, s, g2, PINV_ITERS)),
        Case(name("ppeg_bwd"), "ppeg.cu", "mirror_tpu/ops/ppeg_pallas.py:137", cshape,
             autograd_kernel(torch, ppeg.ppeg_fused, (img, pk, pb), (g5,)),
             lambda: ppeg.ppeg_bwd_ref(img, pk, g5), bars["bwd"], ("dimg", "dk", "db"),
             dict(bytes=3 * nbytes(img) + 2 * nbytes(pk) + nbytes(pb), mma=0,
                  fp32=(2 * 49 * 2 + 2) * img.numel()),
             library=lambda: torch.ops.aten.convolution_backward(
                 g5_nchw, img_nchw, conv_w, [embed], [1, 1], [3, 3], [1, 1], False, [0, 0],
                 embed, [True, True, True])),
        Case(name("conv1d_bwd"), "conv1d.cu", "mirror_tpu/ops/conv1d_pallas.py:224", vshape,
             bwd9, lambda: conv1d.depthwise_conv_seq_bwd_ref(v, kern, g4), bars["bwd"],
             ("dv", "dkern"), dict(bytes=nbytes(v, kern, g4, v, kern), mma=2 * fmas,
                                   mma_peak=peak),
             library=lambda: torch.ops.aten.convolution_backward(
                 g4, v, weight, None, [1, 1], [CONV_TAPS // 2, 0], [1, 1], False, [0, 0],
                 HEADS, [True, True, False])),
    ]


def bf16_outputs(torch, ops):
    """The bf16 instances' outputs at the train slice's shapes from seeded
    inputs (made by torch.randn on the card and softmax, no product),
    {kernel: outputs}: kernels 1, 1b, 2, 2b, 3, 3b, 3c, 4, 4b, 5, 5b, 9, 9b
    through ``ops`` = (landmark, nystrom_attn, pinv, ppeg, conv1d), the ops
    modules of this tree or of an earlier one (scripts/_timing.py's
    load_parent), whose launch wrappers take the same arguments."""
    landmark, nystrom_attn, pinv, ppeg, conv1d = ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    bf16 = torch.bfloat16

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    q = r(B, HEADS, N, DH, scale=DH ** -0.5)
    k, v = r(B, HEADS, N, DH), r(B, HEADS, N, DH)
    out = {}
    res = landmark._launch_fwd(q, k, M, PAD)
    out["landmark_softmax"] = res
    grads = (r(B, HEADS, M, DH), r(B, HEADS, M, DH), r(B, HEADS, M, M))
    out["landmark_softmax_bwd"] = landmark._launch_bwd(res[0], res[1], res[3], N, PAD, *grads)
    x = torch.softmax(r(B, HEADS, M, M).float(), -1).to(bf16)
    s = pinv.global_scale(x)
    out["moore_penrose_pinv"] = (pinv.moore_penrose_pinv(x),)
    out[PINV_BWD] = pinv._pinv_exact_bwd_kernel(x, s, r(B, HEADS, M, M), PINV_ITERS)
    q_l, k_l = res[0], res[1]
    w, kern = r(B, HEADS, M, DH), r(HEADS, CONV_TAPS, scale=CONV_TAPS ** -0.5)
    o3 = nystrom_attn._launch_fwd(q_l, k, v, None, None, PAD, True)
    out["softmax_attn"] = o3[:2]
    out["softmax_attn_q"] = nystrom_attn._launch_fwd(q, k_l, w, None, None, 0, True)[:2]
    o4 = nystrom_attn._launch_fwd(q, k_l, w, v, kern, 0, True)
    out["softmax_attn_conv"] = o4
    g3, g4 = r(B, HEADS, M, DH), r(B, HEADS, N, DH)
    out["softmax_attn_bwd"] = nystrom_attn._launch_bwd(q_l, k, v, g3, o3[1], o3[0], None,
                                                       None)[:3]
    out["softmax_attn_conv_bwd"] = nystrom_attn._launch_bwd(q, k_l, w, g4, o4[1], o4[2], v,
                                                            kern)
    img, pk, pb = r(B, SIDE, SIDE, EMBED), r(7, 7, EMBED, scale=0.1), r(EMBED, scale=0.1)
    out["ppeg"] = (ppeg.ppeg_fused(img, pk, pb),)
    leaves = [t.clone().requires_grad_() for t in (img, pk, pb)]
    out["ppeg_bwd"] = torch.autograd.grad(ppeg.ppeg_fused(*leaves), leaves,
                                          r(B, SIDE, SIDE, EMBED))
    conv = torch.empty_like(v)
    conv1d.conv1d_fwd_into(v, kern, conv)
    out["conv1d"] = (conv,)
    dv, dkern = torch.empty_like(v), torch.empty(HEADS, CONV_TAPS, device=dev)
    conv1d.conv1d_bwd_into(v, kern, g4, dv, dkern, conv1d.conv1d_bwd_scratch(v, CONV_TAPS))
    out["conv1d_bwd"] = (dv, dkern)
    torch.cuda.synchronize()
    return out


def digests(torch, outputs: dict) -> dict:
    """sha256 of each kernel's outputs' bytes, first 16 hex digits."""
    import hashlib

    result = {}
    for name, tensors in outputs.items():
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
        result[name] = h.hexdigest()[:16]
    return result


def phase_instances(torch):
    """Phase 12a: the float32 and float16 instances against their plain
    versions, timed, and the bf16 instances held to the bits of the tree
    before the types were added (BF16_DIGESTS)."""
    from mirror_tpu_torch.ops import conv1d, landmark, nystrom_attn, pinv, ppeg

    t0 = time.perf_counter()
    got = digests(torch, bf16_outputs(torch, (landmark, nystrom_attn, pinv, ppeg, conv1d)))
    differ = sorted(k for k in got if BF16_DIGESTS.get(k) != got[k])
    say(f"[instance] bf16 outputs at the train slice's shapes, sha256 {json.dumps(got)}; "
        f"against the tree before the float32 and float16 instances: "
        f"{'the same bits' if not differ else 'DIFFER in ' + ', '.join(differ)}")
    if differ:
        fail(f"the bf16 instances' bits changed: {differ}")
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    results = []
    for i, dn in enumerate(INSTANCE_DTYPES):
        g = torch.Generator(device=dev).manual_seed(SEED + 40 + i)

        def randn(*shape, scale=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

        for case in instance_cases(torch, randn, getattr(torch, dn)):
            results.append(run_case(torch, case))
        torch.cuda.empty_cache()
    say(f"[instance] phase 12a {time.perf_counter() - t0:.1f} s")
    return results


def phase_train_instances(torch, root: Path, train_root: Path):
    """Phase 12b: train_mirror.main at full width (the pretrain template,
    batch 16, one epoch of 4 steps) with --no-amp and with --amp-dtype
    float16 on phase 5's cohort; the launches of every instance read around
    each run; the .pth.tar reloaded; ms per step and peak memory on one
    resident batch; one batch-2 step against the CPU's float32 plain path."""
    import numpy as np

    from mirror_tpu_torch import train_mirror
    from mirror_tpu_torch.config import parse_args, resolve_lr
    from mirror_tpu_torch.data.datasets import PretrainDataset
    from mirror_tpu_torch.data.loader import Loader
    from mirror_tpu_torch.ops._common import instance
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args
    from mirror_tpu_torch.train.optim import make_optimizer
    from mirror_tpu_torch.train.steps import make_mirror_train_step

    feat_dir, rna_csv = train_root / "features", train_root / "rna.csv"
    base = ["--config", str(PRETRAIN_YAML), "--wsi-feature-dir", str(feat_dir),
            "--rna-feature-csv", str(rna_csv), "--split-dir", str(train_root / "splits"),
            "--fold-nb", "0", "--output", str(root / "runs"), "--epochs", "1", "--no-val",
            "--batch-size", str(B), "--log-interval", "1", "--seed", str(SEED),
            "--workers", "8"]
    dataset = PretrainDataset(str(feat_dir), str(rna_csv), N_TOKENS,
                              splits=str(train_root / "splits"))
    host = next(iter(Loader(dataset, B, shuffle=True, seed=SEED, workers=8)))
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    launches, stats = {}, {}
    for dn, flags in (("float32", ["--no-amp"]), ("float16", ["--amp-dtype", "float16"])):
        dtype, tag = getattr(torch, dn), f"train {dn}"
        argv = [*base, "--experiment", f"smoke_{dn}", *flags]
        results, counts = run_entry_point(torch, tag, train_mirror.main, argv, TRAIN_STEPS)
        launches[dn] = counts
        if results.get("metric_name") != "loss" or not np.isfinite(results["best_metric"]):
            fail(f"[{tag}] --result is not what a finished run prints: {results}")
        missing = [instance(k, dtype) for k in FORWARD + BACKWARD
                   if counts.get(instance(k, dtype), 0) == 0]
        other = [k for k in counts if k in FORWARD + BACKWARD]
        if missing or other:
            fail(f"[{tag}] the train step never launched {missing}, or launched the bf16 "
                 f"instances {other}")
        payload = load_checkpoint_file(str(root / "runs" / "pretrain" / f"smoke_{dn}"
                                           / "last.pth.tar"))
        model_kwargs = run_args(payload)["model_kwargs"]
        model = create_model("mirror", device="cuda", **model_kwargs)
        model.load_state_dict(payload["state_dict"])
        got = compute_dtype(torch, model)
        say(f"[{tag}] last.pth.tar reloads into create_model('mirror'), compute type {got}")
        if got != {"float32": "fp32", "float16": "fp16"}[dn]:
            fail(f"[{tag}] the checkpoint's model computes in {got}")
        del model
        args, _ = parse_args(argv)
        model = create_model("mirror", device="cuda",
                             generator=torch.Generator().manual_seed(SEED), **model_kwargs)
        step = make_mirror_train_step(
            model, make_optimizer(args, model, resolve_lr(args, B)),
            train_mirror.loss_weights_from_args(args), args.wsi_mask_ratio,
            args.rna_mask_ratio, generator=torch.Generator(device="cuda").manual_seed(SEED))
        step_ms, lo, hi, peak_gib, metrics = time_steps(torch, step, batch, reps=5)
        say(f"[{tag}] train step at batch {B}, full width, {dn}: median {step_ms:.3f} ms "
            f"over 5 (min {lo:.3f}, max {hi:.3f}), {1000 * B / step_ms:.1f} samples/s; "
            f"peak device memory {peak_gib:.2f} GiB; loss {float(metrics['loss']):.6g}")
        if not np.isfinite(float(metrics["loss"])):
            fail(f"[{tag}] the timed step's loss is not finite")
        del model, step
        torch.cuda.empty_cache()
        cos, rel = train_step_card_vs_cpu(torch, model_kwargs, args, host["wsi"], host["rna"],
                                          tag=tag, bars=INSTANCE_STEP_BARS[dn],
                                          cpu_float32=True)
        stats[dn] = dict(step_ms=step_ms, peak_gib=peak_gib, worst_grad_cos=cos,
                         step_loss_rel=rel)
    del batch
    torch.cuda.empty_cache()
    return launches, stats


def phase_predict_instances(torch, root: Path):
    """Phase 12c: predict on checkpoints whose args say amp: false and
    amp_dtype: float16 (16 slides through the kernels, token subsample), two
    slides against the CPU's float32 plain path; predict --whole-slide on two
    whole slides in each type (kernels 2, 3, 3b, 9, 5); one CP attention
    layer's gradient at world 1 in each type (3c, 9b, 2b through
    nystrom_attention_cp)."""
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch.data.formats import load_feature_file
    from mirror_tpu_torch.ops import _common
    from mirror_tpu_torch.ops._common import instance
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.tools.predict import predict
    from mirror_tpu_torch.train.checkpoint import save_checkpoint_file

    t_phase = time.perf_counter()
    model = create_model("mirror_classifier", device="cpu",
                         generator=torch.Generator().manual_seed(SEED), num_classes=2,
                         **MODEL_KWARGS)
    sd = model.state_dict()
    feat_dir, rna_csv, ids = write_cohort(root, B, "DT")
    ws_dir = root / "ws_features"
    ws_dir.mkdir()
    rng = np.random.default_rng(SEED + 5)
    ws_ids = [f"TCGA-DT-{i:04d}-01Z-00-DX1" for i in range(len(INSTANCE_WS_SLIDES))]
    for sid, n in zip(ws_ids, INSTANCE_WS_SLIDES):
        np.save(ws_dir / f"{sid}.npy",
                rng.standard_normal((n, EMBED), dtype=np.float32).astype(np.float16))
    launches = {}
    for dn, amp in (("float32", dict(amp=False)), ("float16", dict(amp=True,
                                                                    amp_dtype="float16"))):
        dtype = getattr(torch, dn)
        args = dict(model="mirror_classifier", model_kwargs=MODEL_KWARGS, num_classes=2,
                    classes=list(CLASSES), num_wsi_feature_tokens=N_TOKENS, batch_size=B,
                    wsi_feature_only=False, **amp)
        ckpt = root / f"model_{dn}.pth.tar"
        save_checkpoint_file(str(ckpt), sd, args=args)
        for whole, src, csv in ((False, feat_dir, f"pred_{dn}.csv"),
                                (True, ws_dir, f"ws_{dn}.csv")):
            tag = f"predict {dn}{' --whole-slide' if whole else ''}"
            torch.cuda.synchronize()
            _common.reset_launch_counts()
            t0 = time.perf_counter()
            predict(str(ckpt), "subtyping", str(src), str(root / csv),
                    rna_feature_csv=str(rna_csv), batch_size=B, seed=SEED, device="cuda",
                    whole_slide=whole)
            torch.cuda.synchronize()
            counts = _common.launch_counts()
            launches[f"predict_{dn}" + ("_whole_slide" if whole else "")] = counts
            df = pd.read_csv(root / csv)
            probs = df[["prob_0", "prob_1"]].to_numpy()
            say(f"[{tag}] {len(df)} slides in {time.perf_counter() - t0:.2f} s; kernel "
                f"launches {json.dumps(counts)}")
            want = [instance(k, dtype) for k in (FORWARD if not whole else
                                                 ("moore_penrose_pinv", "softmax_attn",
                                                  "softmax_attn_q", "conv1d", "ppeg"))]
            missing = [k for k in want if counts.get(k, 0) == 0]
            if missing or not np.isfinite(probs).all() or \
                    np.abs(probs.sum(1) - 1.0).max() > 1e-5:
                fail(f"[{tag}] never launched {missing}, or its probabilities are not finite "
                     "or do not sum to 1")
        # two slides: the card's kernels in the type against the CPU's float32 plain path
        wsi = []
        for sid in ids[:2]:
            feats = np.asarray(load_feature_file(str(feat_dir / f"{sid}.npy")), np.float32)
            wsi.append(feats[rng.choice(feats.shape[0], N_TOKENS,
                                        replace=feats.shape[0] < N_TOKENS)])
        rna = pd.read_csv(rna_csv, index_col=0).to_numpy(np.float32)[:2]
        wsi_t, rna_t = torch.from_numpy(np.stack(wsi)), torch.from_numpy(rna)
        with torch.no_grad():
            gpu = create_model("mirror_classifier", device="cuda", num_classes=2,
                               **dict(MODEL_KWARGS, **({"dtype": dn} if dn != "float32"
                                                        else {})))
            gpu.load_state_dict(sd)
            got = gpu(wsi_t.cuda(), rna_t.cuda()).float().cpu()
            cpu = create_model("mirror_classifier", device="cpu", num_classes=2,
                               **MODEL_KWARGS)
            cpu.load_state_dict(sd)
            want_logits = cpu(wsi_t, rna_t).float()
        rel = ((got - want_logits).norm() / want_logits.norm()).item()
        say(f"[predict {dn}] 2 slides, card kernels ({dn}) vs CPU plain path (fp32): logits "
            f"{got.tolist()} vs {want_logits.tolist()}, relative error {rel:.4g} (bound "
            f"{INSTANCE_LOGITS[dn]:g})")
        if not torch.isfinite(got).all() or rel > INSTANCE_LOGITS[dn]:
            fail(f"[predict {dn}] the card's logits disagree with the CPU reference")
        del gpu, cpu
        torch.cuda.empty_cache()
        launches[f"cp_grad_{dn}"] = cp_grad_instance(torch, dtype)
    say(f"[predict instances] phase 12c {time.perf_counter() - t_phase:.1f} s")
    return launches


def cp_grad_instance(torch, dtype):
    """One CP attention layer (phase 10's, in ``dtype``) forward and backward
    at world 1 through nystrom_attention_cp, launches read around it, the
    output and dL/dx against the same layer's plain path on the card in
    float32 (use_pallas=False)."""
    from mirror_tpu_torch.models.nystrom import NystromAttention
    from mirror_tpu_torch.ops import _common

    dn = str(dtype).split(".")[-1]
    kwargs, attn, x, t = ws_attention(torch)
    state = attn.state_dict()
    attn = NystromAttention(**dict(kwargs, dtype=dtype))
    attn.load_state_dict(state)
    torch.cuda.synchronize()
    _common.reset_launch_counts()
    out, dx, _ = cp_attention_here(torch, attn.eval(), x, t)
    torch.cuda.synchronize()
    counts = _common.launch_counts()
    plain = NystromAttention(**dict(kwargs, dtype=None, use_pallas=False))
    plain.load_state_dict(state)
    out_ref, dx_ref, _ = cp_attention_here(torch, plain.eval(), x, t)
    rel, _ = seq_agreement(torch, out, out_ref)
    a, b = dx.double().ravel(), dx_ref.double().ravel()
    cos = (a @ b / (a.norm() * b.norm())).item()
    bound_rel, bound_cos = (1e-3, 0.9999) if dn == "float32" else (BOUND_STEP_LOSS,
                                                                  BOUND_GRAD_COS)
    say(f"[cp_grad {dn}] one CP attention layer ({WS_GRAD_N} rows) forward and backward at "
        f"world 1, kernels in {dn} against the plain path in fp32 on the card: output "
        f"relative error {rel:.4g} (bound {bound_rel:g}), dL/dx cosine {cos:.6f} (bound "
        f"{bound_cos}); kernel launches {json.dumps(counts)}")
    if not (rel <= bound_rel and cos >= bound_cos):
        fail(f"[cp_grad {dn}] the CP layer's kernels leave their bars")
    torch.cuda.empty_cache()
    return counts


# phase 13: every Nystrom width the JAX package serves. (embed, tile feature
# width): embed 1536 on 1536-wide tile features (UNI2-h, Prov-GigaPath's tile
# encoder, H-optimus-0): 8 heads of 192, 768 landmarks, front pad 187 at 2117
# rows; embed 792 on Phikon's 768-wide features: 8 heads of 99, 396
# landmarks, pad 259. The rest is the subtyping template (MODEL_KWARGS).
WIDTHS = ((1536, 1536), (792, 768))
# predict's slides a width (bf16: the rate), and in float32 and float16 (the
# launches); the whole slides (patches): encode_slide's at embed 1536, and
# predict --whole-slide's in each type at each width
WIDTH_SLIDES, WIDTH_TYPE_SLIDES = 16, 4
WIDTH_WS_PATCHES, WIDTH_WS_SMALL = 15000, 3000
WIDTH_TYPES = (("bfloat16", dict(amp=True, amp_dtype="bfloat16")),
               ("float32", dict(amp=False)),
               ("float16", dict(amp=True, amp_dtype="float16")))


def width_kwargs(embed: int, wsi_dim: int) -> dict:
    return dict(MODEL_KWARGS, embed_dim=embed, wsi_embed_dim=wsi_dim)


def phase_width_kernels(torch):
    """Phase 13a: kernels 1-5 and 9 at embed 1536's and embed 792's serving
    shapes (:func:`instance_cases` at those widths, forward only) in bf16
    (timed, with the library calls), float32 (3, 3b and 4 timed, the others
    checked) and float16 (checked): each against its plain version in its
    type at the instances' bars."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    results = []
    for embed, _ in WIDTHS:
        for i, dn in enumerate(("bfloat16", "float32", "float16")):
            g = torch.Generator(device=dev).manual_seed(SEED + 50 + i + embed)

            def randn(*shape, scale=1.0, dtype=torch.bfloat16):
                return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

            for case in instance_cases(torch, randn, getattr(torch, dn), embed, backward=False):
                timed = dn == "bfloat16" or (dn == "float32" and "softmax_attn" in case.name)
                results.append(run_case(torch, case) if timed else check_case(torch, case))
            torch.cuda.empty_cache()
    say(f"[widths] phase 13a {time.perf_counter() - t0:.1f} s")
    return [r for r in results if r is not None]


def check_case(torch, case: Case) -> None:
    """A case's kernel against its plain version, errors only (no times)."""
    out = case.kernel()
    ref = case.plain()
    torch.cuda.synchronize()
    errs = errors(torch, out, ref)
    per_output = ", ".join(f"{o} {a:.4g}/{r:.4g}" for o, (a, r) in zip(case.outputs, errs))
    say(f"[widths] {case.name} ({case.shape}): max abs / rel Frobenius err {per_output} "
        f"(bound {case.tol:g})")
    ok = case.check(out, ref) if case.check is not None else True
    if not ok or not all(rel <= case.tol for _, rel in errs):
        fail(f"{case.name} ({case.shape}) disagrees with its plain version beyond its bound")


def write_width_cohort(root: Path, wsi_dim: int, n_slides: int, whole: int):
    """n_slides slides of 500-2500 patches of wsi_dim features (fp16 .npy),
    an RNA CSV of 10234 genes, and one whole slide of ``whole`` patches in a
    folder of its own (with its RNA row); numpy seeded from SEED."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(SEED + wsi_dim)
    feat_dir, ws_dir = root / "features", root / "whole"
    feat_dir.mkdir(parents=True)
    ws_dir.mkdir()
    ids = [f"TCGA-WD-{i:04d}-01Z-00-DX1" for i in range(n_slides)]
    for sid in ids:
        n = int(rng.integers(500, 2501))
        np.save(feat_dir / f"{sid}.npy",
                rng.standard_normal((n, wsi_dim), dtype=np.float32).astype(np.float16))
    np.save(ws_dir / f"{ids[0]}.npy", rng.standard_normal((whole, wsi_dim), dtype=np.float32)
            .astype(np.float16))
    pd.DataFrame(rng.standard_normal((n_slides, RNA_DIM), dtype=np.float32),
                 index=[s[:15] for s in ids],
                 columns=[f"gene_{j}" for j in range(RNA_DIM)]).to_csv(root / "rna.csv")
    return feat_dir, ws_dir, root / "rna.csv", ids


def run_predict(torch, tag, ckpt, src, out_csv, rna_csv, whole, n_slides, want):
    """predict on the card with the counts set to 0 just before and read just
    after; the CSV checked; returns (counts, seconds, peak GiB)."""
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch.ops import _common
    from mirror_tpu_torch.tools.predict import predict

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _common.reset_launch_counts()
    t0 = time.perf_counter()
    predict(str(ckpt), "subtyping", str(src), str(out_csv), rna_feature_csv=str(rna_csv),
            batch_size=B, seed=SEED, device="cuda", whole_slide=whole)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _common.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    df = pd.read_csv(out_csv)
    probs = df[["prob_0", "prob_1"]].to_numpy()
    missing = [k for k in want if counts.get(k, 0) == 0]
    say(f"[{tag}] {len(df)} slides in {seconds:.2f} s ({len(df) / seconds:.2f} slides/s, "
        f"checkpoint load, file reads and CSV included), peak device memory {peak:.2f} GiB; "
        f"kernel launches {json.dumps(counts)}")
    if len(df) != n_slides or missing or not np.isfinite(probs).all() or \
            np.abs(probs.sum(1) - 1.0).max() > 1e-5:
        fail(f"[{tag}] {len(df)} rows, never launched {missing}, or its probabilities are not "
             "finite or do not sum to 1")
    return counts, seconds, peak


def phase_widths(torch, root: Path):
    """Phase 13b: predict (16 slides in bf16, 4 in float32 and float16; two
    slides against the CPU's float32 plain path) and predict --whole-slide
    (one slide in each type) on embed-1536 and embed-792 checkpoints;
    encode_slide on a 15,000-patch slide at embed 1536; the exported
    embed-1536 classifier against its eager module, bit for bit; the
    training CLI at embed 1536 refused at start. Returns the launches of
    each run by path."""
    import numpy as np
    import pandas as pd

    from mirror_tpu_torch import train_mirror
    from mirror_tpu_torch.data.formats import load_feature_file
    from mirror_tpu_torch.ops import _common
    from mirror_tpu_torch.ops._common import instance
    from mirror_tpu_torch.registry import create_model
    from mirror_tpu_torch.tools import encode_slide, export_model
    from mirror_tpu_torch.tools.export_model import build_inference_module
    from mirror_tpu_torch.train.checkpoint import save_checkpoint_file

    t_phase = time.perf_counter()
    paths = {}
    for embed, wsi_dim in WIDTHS:
        t0 = time.perf_counter()
        kwargs = width_kwargs(embed, wsi_dim)
        model = create_model("mirror_classifier", device="cpu", num_classes=2,
                             generator=torch.Generator().manual_seed(SEED + embed), **kwargs)
        sd = model.state_dict()
        del model
        sub = root / f"embed{embed}"
        feat_dir, ws_dir, rna_csv, ids = write_width_cohort(
            sub, wsi_dim, WIDTH_SLIDES, WIDTH_WS_SMALL)
        ckpts = {}
        for dn, amp in WIDTH_TYPES:
            args = dict(model="mirror_classifier", model_kwargs=kwargs, num_classes=2,
                        classes=list(CLASSES), num_wsi_feature_tokens=N_TOKENS, batch_size=B,
                        wsi_feature_only=False, **amp)
            ckpts[dn] = sub / f"model_{dn}.pth.tar"
            save_checkpoint_file(str(ckpts[dn]), sd, args=args)
        n_params = sum(t.numel() for t in sd.values())
        say(f"[widths] embed {embed} (8 heads of {embed // 8}, {embed // 2} landmarks, "
            f"{wsi_dim}-wide tile features): {n_params} random parameters in 3 checkpoints, "
            f"{WIDTH_SLIDES} slides and a {WIDTH_WS_SMALL}-patch slide, set-up "
            f"{time.perf_counter() - t0:.1f} s")
        few = sub / "few"
        few.mkdir()
        for sid in ids[:WIDTH_TYPE_SLIDES]:
            (few / f"{sid}.npy").symlink_to(feat_dir / f"{sid}.npy")
        for dn, _ in WIDTH_TYPES:
            dtype = getattr(torch, dn)
            src, n_sl = (feat_dir, WIDTH_SLIDES) if dn == "bfloat16" else \
                (few, WIDTH_TYPE_SLIDES)
            counts, seconds, peak = run_predict(
                torch, f"widths predict embed {embed} {dn}", ckpts[dn], src,
                sub / f"pred_{dn}.csv", rna_csv, False, n_sl,
                [instance(k, dtype) for k in FORWARD])
            paths[f"widths_predict_{embed}_{dn}"] = counts
            if dn == "bfloat16":
                say(f"[widths] predict at embed {embed}: {WIDTH_SLIDES / seconds:.2f} slides/s "
                    f"(bf16, one batch of {B}), peak device memory {peak:.2f} GiB")
            counts, _, _ = run_predict(
                torch, f"widths predict --whole-slide embed {embed} {dn}", ckpts[dn], ws_dir,
                sub / f"ws_{dn}.csv", rna_csv, True, 1,
                [instance(k, dtype) for k in ("moore_penrose_pinv", "softmax_attn",
                                              "softmax_attn_q", "conv1d", "ppeg")])
            paths[f"widths_whole_slide_{embed}_{dn}"] = counts
        # two slides: the card's bf16 kernels against the CPU's float32 plain path
        rng = np.random.default_rng(SEED)
        wsi = []
        for sid in ids[:2]:
            feats = np.asarray(load_feature_file(str(feat_dir / f"{sid}.npy")), np.float32)
            wsi.append(feats[rng.choice(feats.shape[0], N_TOKENS,
                                        replace=feats.shape[0] < N_TOKENS)])
        rna = pd.read_csv(rna_csv, index_col=0).to_numpy(np.float32)[:2]
        wsi_t, rna_t = torch.from_numpy(np.stack(wsi)), torch.from_numpy(rna)
        with torch.no_grad():
            gpu = create_model("mirror_classifier", device="cuda", num_classes=2,
                               dtype="bfloat16", **kwargs)
            gpu.load_state_dict(sd)
            got = gpu(wsi_t.cuda(), rna_t.cuda()).float().cpu()
            del gpu
            cpu = create_model("mirror_classifier", device="cpu", num_classes=2, **kwargs)
            cpu.load_state_dict(sd)
            want = cpu(wsi_t, rna_t).float()
            del cpu
        rel = ((got - want).norm() / want.norm()).item()
        say(f"[widths] embed {embed}, 2 slides, card kernels (bf16) vs CPU plain path (fp32): "
            f"logits {got.tolist()} vs {want.tolist()}, relative error {rel:.4g} (bound "
            f"{BOUND_LOGITS:g})")
        if not torch.isfinite(got).all() or rel > BOUND_LOGITS:
            fail(f"[widths] embed {embed}: the card's logits disagree with the CPU reference")
        torch.cuda.empty_cache()
        if embed != 1536:
            continue
        # encode_slide: a 15,000-patch slide, every patch
        big = sub / "big"
        big.mkdir()
        np.save(big / f"{ids[0]}.npy", np.random.default_rng(SEED + 7).standard_normal(
            (WIDTH_WS_PATCHES, wsi_dim), dtype=np.float32).astype(np.float16))
        torch.cuda.synchronize()
        _common.reset_launch_counts()
        t0 = time.perf_counter()
        encode_slide.main(["--wsi-feature-dir", str(big), "--checkpoint", str(ckpts["bfloat16"]),
                           "--output", str(sub / "emb"), "--save", "cls", "--dtype", "bfloat16"])
        torch.cuda.synchronize()
        counts = _common.launch_counts()
        paths["widths_encode_slide"] = counts
        emb = np.load(sub / "emb" / f"{ids[0]}.npy")
        say(f"[widths] encode_slide at embed {embed}: one {WIDTH_WS_PATCHES}-patch slide in "
            f"{time.perf_counter() - t0:.2f} s (encoder build and read included); kernel "
            f"launches {json.dumps(counts)}")
        want = {"moore_penrose_pinv": 2, "softmax_attn": 2, "softmax_attn_q": 2, "conv1d": 2,
                "ppeg": 1, PINV_GEMM: 2 * 4 * PINV_ITERS}
        if counts != want or emb.shape != (embed,) or not np.isfinite(emb).all():
            fail(f"[widths] encode_slide: launches {counts} (expected {want}) or its "
                 f"embedding {emb.shape} is not finite")
        # the exported classifier against the eager module, bit for bit
        t0 = time.perf_counter()
        pt2 = sub / "classifier.pt2"
        manifest = export_model.export_model("classifier", "mirror_classifier",
                                             str(ckpts["bfloat16"]), str(pt2), B, N_TOKENS,
                                             wsi_dim, RNA_DIM, {}, device="cuda")
        program = torch.export.load(str(pt2)).module()
        g = torch.Generator().manual_seed(SEED + 13)
        wsi_e = torch.randn(B, N_TOKENS, wsi_dim, generator=g).cuda()
        rna_e = torch.randn(B, RNA_DIM, generator=g).cuda()
        with torch.no_grad():
            torch.cuda.synchronize()
            _common.reset_launch_counts()
            exported = program(wsi_e, rna_e)
            torch.cuda.synchronize()
            counts = _common.launch_counts()
            eager = build_inference_module("classifier", "mirror_classifier",
                                           str(ckpts["bfloat16"]), {}, torch.device("cuda"))(
                wsi_e, rna_e)
        paths["widths_export"] = counts
        same = torch.equal(exported, eager)
        say(f"[widths] export_model at embed {embed}: exported and loaded in "
            f"{time.perf_counter() - t0:.1f} s, ops {manifest['ops']}; one batch of {B} "
            f"launched {json.dumps(counts)}; against the eager module: "
            f"{'bit for bit' if same else 'DIFFERENT'} (max abs difference "
            f"{(exported.float() - eager.float()).abs().max().item():.4g})")
        # (export_model traces the checkpoint's model in float32: its instances)
        missing = [k for k in FORWARD if counts.get(instance(k, torch.float32), 0) == 0]
        if not same or missing:
            fail(f"[widths] the exported embed-{embed} classifier differs from the eager "
                 f"module, or never launched {missing}")
        del program, exported, eager
        torch.cuda.empty_cache()
    # training at embed 1536 stops at start, naming the backward kernels
    argv = ["--config", str(PRETRAIN_YAML), "--wsi-feature-dir", str(root / "none"),
            "--model-kwargs", "embed_dim=1536", "wsi_embed_dim=1536"]
    try:
        train_mirror.main(argv)
    except ValueError as e:
        refused = str(e)
    else:
        refused = ""
    say(f"[widths] train_mirror at embed 1536: {refused or 'NOT refused'}")
    if "backward kernels (1b, 3c, 4b, 9b)" not in refused or "--no-use-pallas" not in refused:
        fail("[widths] train_mirror at embed 1536 was not refused by name at start")
    say(f"[widths] phase 13b {time.perf_counter() - t_phase:.1f} s")
    return paths


def run_model_kwargs(train_root: Path) -> dict:
    """The model kwargs phase 5's checkpoint was saved with."""
    from mirror_tpu_torch.train.checkpoint import load_checkpoint_file, run_args

    payload = load_checkpoint_file(str(train_root / "runs" / "pretrain" / "smoke"
                                       / "last.pth.tar"))
    return run_args(payload)["model_kwargs"]


def main() -> int:
    import torch

    smi = phase_device(torch)
    torch.set_num_threads(8)
    if sys.argv[1:2] in (["--ddp-ranks"], ["--cp-ranks"]):
        (phase_ddp_cards if sys.argv[1] == "--ddp-ranks" else phase_cp_cards)(
            torch, int(sys.argv[2]))
        say(f"[done] on {' | '.join(smi.splitlines())}")
        say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0
    t_start = time.perf_counter()
    phase_build()
    kernels = phase_kernels(torch, backward=False)
    kernels += phase_kernels(torch, backward=True)
    kernels += phase_instances(torch)
    build_root = REPO / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        serve = phase_slice(torch, Path(tmp))
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        instance_paths = phase_predict_instances(torch, Path(tmp))
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        train, train_exact, _ = phase_train(torch, Path(tmp) / "train")
        train_instances, _ = phase_train_instances(torch, Path(tmp) / "instances",
                                                   Path(tmp) / "train")
        instance_paths.update({f"train_{dn}": c for dn, c in train_instances.items()})
        clip, _ = phase_pretrain_clip(torch, Path(tmp) / "clip",
                                      Path(tmp) / "train" / "features",
                                      Path(tmp) / "train" / "rna.csv")
        gradckpt, _ = phase_run_control(torch, Path(tmp) / "run_control",
                                        Path(tmp) / "train" / "features",
                                        Path(tmp) / "train" / "rna.csv",
                                        run_model_kwargs(Path(tmp) / "train"))
        train_ddp, _ = phase_ddp(torch, Path(tmp) / "ddp", Path(tmp) / "train" / "features",
                                 Path(tmp) / "train" / "rna.csv",
                                 run_model_kwargs(Path(tmp) / "train"))
        train_tp, _ = phase_tp(torch, Path(tmp) / "tp", Path(tmp) / "train" / "features",
                               Path(tmp) / "train" / "rna.csv",
                               run_model_kwargs(Path(tmp) / "train"))
        with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp_fg:
            featgen = phase_featgen(torch, Path(tmp_fg))
        pretrain_ckpt = Path(tmp) / "train" / "runs" / "pretrain" / "smoke" / "last.pth.tar"
        down = phase_downstream(torch, Path(tmp) / "downstream", pretrain_ckpt)
        export, _ = phase_tools(torch, Path(tmp) / "tools", Path(tmp) / "train",
                                Path(tmp) / "downstream")
    selftest_launches = phase_selftest(torch)
    probe_launches = phase_probes(torch)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        whole_slide, _, ws_kernels = phase_whole_slide(torch, Path(tmp))
    merge_shapes({k["name"]: k for k in kernels}, ws_kernels)
    merge_shapes({k["name"]: k for k in kernels}, phase_width_kernels(torch))
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        width_paths = phase_widths(torch, Path(tmp))
    # the main paths' launches: predict's, the train step's (implicit and
    # exact pinv gradient, one step with --grad-checkpointing, the
    # one-rank NCCL run of phase 5d and rank 0's model-parallel run of
    # phase 5e), the
    # CLIP baseline's, feature extraction's (its
    # three runs), the downstream entry points' (and the optimizer side's
    # survival run), the exported programs' (phase 11: the classifier's and
    # the embed's batch, in a fresh process), the self-test's and
    # encode_slide's (the whole-slide path, the only caller of
    # softmax_attn_q, the pad-0 entry of the softmax_attn kernel), each
    # counted from 0 just before its run.
    # ln_qkv and ln_qkv_bwd, library-only as in the JAX package, run on the
    # probes' path (exp_ln_qkv), as do the kernels the probes added
    paths = {"predict": serve, "train": train, "train_exact": train_exact,
             "train_gradckpt": gradckpt, "train_ddp": train_ddp, "train_tp": train_tp,
             "pretrain_clip": clip, "featgen": featgen, "subtyping": down["subtyping"],
             "survival": down["survival"], "survival_opt": down["survival_opt"],
             "export": export, "selftest": selftest_launches, "probes": probe_launches,
             "whole_slide": whole_slide, **instance_paths, **width_paths}
    for k in kernels:
        k["launches_by_path"] = {path: counts.get(k["name"], 0) for path, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    unlaunched = [k["name"] for k in kernels if k["launches"] == 0]
    if unlaunched:
        fail(f"kernels no main path launched: {unlaunched}")
    say(f"[done] {time.perf_counter() - t_start:.1f} s after the device check, on {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
