#!/usr/bin/env python3
"""Drive the PyTorch port of MIRROR once on one NVIDIA card, and check it.

    python3 chip_smoke.py            # from the repo root; one CUDA card, nvcc

Phases, each printed as it finishes:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of ``mirror_tpu_torch/csrc`` compiled from the
   checkout's sources, with its build time;
3. kernels: each kernel of the slice against its plain PyTorch version on
   the card, at the shapes the slice gives it (batch 16, 8 heads, 2117
   rows, dh 96, 384 landmarks, front pad 187; PPEG on [16, 46, 46, 768]),
   bf16: max abs error, relative Frobenius error, the bound, and the median
   time of both over warm launches (CUDA events);
4. slice: a full-width ``mirror_classifier`` (the subtyping configuration:
   768-d Phikon features, embed 768, RNA 10234, 2048 tokens, bf16) with
   random weights from a seeded generator, saved as a reference
   ``.pth.tar``; 48 synthetic slides scored by
   ``mirror_tpu_torch.tools.predict.predict`` with batch 16, every kernel's
   launch count read around that run, the CSV checked, and two slides
   re-scored on the CPU by the plain path as the reference.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
The script imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0

# the slice's shapes (configs/subtyping/mirror.template.yaml)
B, HEADS, DH, M = 16, 8, 96, 384
N_TOKENS = 2048
SIDE = 46  # ceil(sqrt(2048)): 2116 grid tokens
N = SIDE * SIDE + 1  # + cls: 2117 rows into each Nystrom attention
PAD = (M - N % M) % M  # 187 front-pad rows, never built
EMBED, RNA_DIM, CONV_TAPS = 768, 10234, 33
MODEL_KWARGS = dict(
    wsi_embed_dim=768, rna_embed_dim=RNA_DIM, embed_dim=EMBED, rna_encoder_depth=2,
    rna_gene_embed="learn", rna_mlp_ratio=4.0, rna_pos_drop_rate=0.0,
    rna_proj_drop_rate=0.1, rna_attn_drop_rate=0.0, rna_drop_path_rate=0.0,
    rna_norm_layer="layernorm", rna_act_layer="gelu", fusion="concat",
)
N_SLIDES = 48

# Bounds on the relative Frobenius error of a kernel against its plain
# version. Outputs rounded once to bf16 after an fp32 sum taken in another
# order: a bf16 rounding is at most 2^-9 = 2e-3 relative, and the attention
# also rounds its unnormalised probabilities before the product, so 1e-2
# leaves 5x room. The pinv chains 24 bf16 products whose one-ulp
# differences the 6 unconverged iterations amplify: 1e-1, and it is also
# held by function, |x z - I| no worse than 1.5x the plain version's.
BOUND_SINGLE_ROUNDING = 1e-2
BOUND_PINV = 1e-1
# The slide scores of the card (kernels, bf16) against the CPU's plain path
# (bf16): a relative error of the logits up to 5e-2, the drift of bf16
# rounding through two Nystrom layers and their pinvs; a wiring fault (a
# lost conv, pad or head order) moves them by O(1).
BOUND_LOGITS = 5e-2


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


def compare(torch, out, ref):
    """(max abs error, relative Frobenius error) of out against ref."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    max_abs, rel = 0.0, 0.0
    for o, r in zip(outs, refs):
        if o.shape != r.shape or not torch.isfinite(o.float()).all():
            fail(f"kernel output shape {tuple(o.shape)} vs {tuple(r.shape)}, or not finite")
        d = o.float() - r.float()
        max_abs = max(max_abs, d.abs().max().item())
        rel = max(rel, (d.norm() / r.float().norm()).item())
    return max_abs, rel


def phase_kernels(torch):
    from mirror_tpu_torch.ops import landmark, nystrom_attn, pinv, ppeg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    q = randn(B, HEADS, N, DH, scale=DH ** -0.5)
    k, v = randn(B, HEADS, N, DH), randn(B, HEADS, N, DH)
    q_l, k_l, attn2 = landmark.landmark_softmax_ref(q, k, M, PAD)
    w = randn(B, HEADS, M, DH)
    kern = randn(HEADS, CONV_TAPS, scale=CONV_TAPS ** -0.5)
    img = randn(B, SIDE, SIDE, EMBED)
    ppeg_k, ppeg_b = randn(7, 7, EMBED, scale=0.1), randn(EMBED, scale=0.1)
    s = pinv.global_scale(attn2)

    cases = [
        ("landmark_softmax", "landmark.cu", "mirror_tpu/ops/landmark_pallas.py:183",
         lambda: landmark.landmark_softmax(q, k, M, PAD),
         lambda: landmark.landmark_softmax_ref(q, k, M, PAD), BOUND_SINGLE_ROUNDING),
        ("moore_penrose_pinv", "pinv.cu", "mirror_tpu/ops/pinv_pallas.py:239",
         lambda: pinv.moore_penrose_pinv(attn2),
         lambda: pinv.pinv_iterations_ref(attn2, s), BOUND_PINV),
        ("softmax_attn", "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:202",
         lambda: nystrom_attn.softmax_matmul_landmark_kv(q_l, k, v, PAD),
         lambda: nystrom_attn.softmax_attn_ref(q_l, k, v, PAD).to(bf16),
         BOUND_SINGLE_ROUNDING),
        ("softmax_attn_conv", "softmax_attn.cu", "mirror_tpu/ops/nystrom_pallas.py:354",
         lambda: nystrom_attn.fused_softmax_attn_conv(q, k_l, w, v, kern),
         lambda: (nystrom_attn.softmax_attn_ref(q, k_l, w)
                  + nystrom_attn.depthwise_conv_seq_ref(v, kern)).to(bf16),
         BOUND_SINGLE_ROUNDING),
        ("ppeg", "ppeg.cu", "mirror_tpu/ops/ppeg_pallas.py:179",
         lambda: ppeg.ppeg_fused(img, ppeg_k, ppeg_b),
         lambda: ppeg.ppeg_ref(img, ppeg_k, ppeg_b), BOUND_SINGLE_ROUNDING),
    ]
    results = []
    for name, src, replaces, kernel_fn, plain_fn, bound in cases:
        out = kernel_fn()
        ref = plain_fn()
        torch.cuda.synchronize()
        max_abs, rel = compare(torch, out, ref)
        ok = rel <= bound
        if name == "moore_penrose_pinv":
            eye = torch.eye(M, device=dev)
            err = (attn2.float() @ out.float() - eye).abs().max().item()
            err_ref = (attn2.float() @ ref.float() - eye).abs().max().item()
            ok = ok and err <= max(1.5 * err_ref, 0.05)
            say(f"[kernel] {name}: |x z - I| max {err:.4g} (plain {err_ref:.4g})")
        ms, plain_ms = median_ms(torch, kernel_fn), median_ms(torch, plain_fn)
        say(f"[kernel] {name}: max abs err {max_abs:.4g}, rel Frobenius err {rel:.4g} "
            f"(bound {bound:g}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median "
            f"of 20 warm)")
        if not ok:
            fail(f"{name} disagrees with its plain version beyond its bound")
        results.append(dict(name=name, route="cuda", source=f"mirror_tpu_torch/csrc/{src}",
                            replaces=replaces, max_abs_err=max_abs, rel_fro_err=rel,
                            ms=ms, plain_ms=plain_ms))
    return results


def write_cohort(root: Path):
    """48 slides of 1000-4000 fp16 Phikon-width patches, an RNA CSV with
    10234 genes, all from numpy generators seeded with SEED."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(SEED)
    feat_dir = root / "features"
    feat_dir.mkdir()
    ids = [f"TCGA-SM-{i:04d}-01Z-00-DX1" for i in range(N_SLIDES)]
    for sid in ids:
        n = int(rng.integers(1000, 4001))
        np.save(feat_dir / f"{sid}.npy",
                rng.standard_normal((n, 768), dtype=np.float32).astype(np.float16))
    rna = rng.standard_normal((N_SLIDES, RNA_DIM), dtype=np.float32)
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
    feat_dir, rna_csv, ids = write_cohort(root)
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
    return launches


def main() -> int:
    import torch

    phase_device(torch)
    sys.path.insert(0, str(REPO))
    phase_build()
    kernels = phase_kernels(torch)
    build_root = REPO / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_") as tmp:
        launches = phase_slice(torch, Path(tmp))
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        fail(f"the slice never launched: {missing}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
